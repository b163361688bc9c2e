"""PyTorch port's match reduction and matcher against the JAX package's
`match_reduce` (Pallas, interpret mode) and `match_fn` (XLA): all five
reduction vectors and every `Matches` field must be exactly equal,
tie-breaks included (cases as in tests/test_match_pallas.py)."""

import jax
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.kernels.match_pallas import match_reduce as jax_match_reduce
from akaze_tpu.matching.hamming import match_fn as jax_match_fn
from akaze_tpu_torch.core.config import MatchConfig
from akaze_tpu_torch.kernels.match import match_reduce
from akaze_tpu_torch.matching.hamming import match, match_fn

torch.set_num_threads(2)


def _random_descs(rng, n, words=16):
    d = rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)
    d[:, -1] &= (1 << 6) - 1
    return d


def _case(ka, kb, seed):
    rng = np.random.default_rng(seed)
    a, b = _random_descs(rng, ka), _random_descs(rng, kb)
    n = min(ka, kb) // 2
    b[:n] = a[:n]  # exact correspondences
    a[ka // 2 :] = a[: ka - ka // 2]  # duplicate rows in A
    b[kb - 8 :] = b[:8]  # duplicate rows in B
    return a, rng.random(ka) > 0.1, b, rng.random(kb) > 0.1


def _t(d):
    return torch.from_numpy(d.view(np.int32))[None]


@pytest.mark.parametrize("ka,kb", [(64, 80), (256, 256), (512, 128)])
@pytest.mark.parametrize("mutual", [True, False])
def test_match_equals_jax(monkeypatch, ka, kb, mutual):
    a, va, b, vb = _case(ka, kb, ka + kb + mutual)
    want = jax_match_reduce(a, va, b, vb, interpret=True)
    got = match_reduce(_t(a), torch.from_numpy(va)[None], _t(b), torch.from_numpy(vb)[None])
    for name, w, g in zip(("best", "second", "nn", "colmin", "colarg"), want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=name)

    monkeypatch.setenv("AKAZE_MATCH", "xla")
    ref = jax_match_fn(a, va, b, vb, JaxMatchConfig(mutual=mutual))
    m = match_fn(_t(a)[0], torch.from_numpy(va), _t(b)[0], torch.from_numpy(vb), MatchConfig(mutual=mutual))
    np.testing.assert_array_equal(m.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(m.distance.numpy(), np.asarray(ref.distance))
    np.testing.assert_array_equal(m.accepted.numpy(), np.asarray(ref.accepted))
    assert m.accepted.sum() > 0


def test_match_batched_pairs_equal_single(monkeypatch):
    """One call over P pairs (the port's written-out batch axis) equals the
    JAX matcher vmapped over the same pairs; numpy uint32 input and
    device="cpu" go through the public `match`."""
    cases = [_case(128, 128, s) for s in range(3)]
    a, va, b, vb = (np.stack(x) for x in zip(*cases))
    monkeypatch.setenv("AKAZE_MATCH", "xla")
    ref = jax.vmap(lambda *x: jax_match_fn(*x, JaxMatchConfig()))(a, va, b, vb)
    m = match(a, va, b, vb, device="cpu")
    assert m.idx_b.shape == (3, 128)
    np.testing.assert_array_equal(m.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(m.distance.numpy(), np.asarray(ref.distance))
    np.testing.assert_array_equal(m.accepted.numpy(), np.asarray(ref.accepted))


def test_match_all_invalid_b(monkeypatch):
    rng = np.random.default_rng(7)
    a, b = _random_descs(rng, 64), _random_descs(rng, 64)
    va, vb = np.ones(64, bool), np.zeros(64, bool)
    want = jax_match_reduce(a, va, b, vb, interpret=True)
    got = match_reduce(_t(a), torch.from_numpy(va)[None], _t(b), torch.from_numpy(vb)[None])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert (got[0] == 1 << 30).all() and (got[1] == 1 << 30).all() and (got[2] == 0).all()
    monkeypatch.setenv("AKAZE_MATCH", "xla")
    ref = jax_match_fn(a, va, b, vb, JaxMatchConfig())
    m = match(a, va, b, vb, device="cpu")
    assert not m.accepted.any()
    np.testing.assert_array_equal(m.idx_b.numpy(), np.asarray(ref.idx_b))
    np.testing.assert_array_equal(m.distance.numpy(), np.asarray(ref.distance))
