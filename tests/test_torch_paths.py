"""The port's two further paths against the JAX package on the CPU, held to
the slice gates of tests/test_torch_pipeline.py (equal keypoint selection,
Hamming mean <= 3 bits, accepted matches within 5 %):

- path A: extract_batch with describe_backend="xla" plus the consecutive
  match, against the JAX extract_batch_fn with describe_backend="xla" and
  patch_backend="pallas" (its patch gather in interpret mode);
- path B: the single-image per-level extract_fn against the JAX
  extract_fn's per-level branch.

Also the describe_backend dispatch: "auto"/"fused" take the fused describe,
"xla"/"pallas" the chunked one, and both give the main path's keypoints."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.frontend.pipeline import extract_batch_fn as jax_extract_batch_fn
from akaze_tpu.frontend.pipeline import extract_fn as jax_extract_fn
from akaze_tpu.matching.hamming import match_fn as jax_match_fn
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend import describe as tdescribe
from akaze_tpu_torch.frontend.pipeline import extract_batch, extract_fn
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.matching.hamming import match
from torch_port_helpers import pair_keypoints

torch.set_num_threads(2)

H, W = 240, 320
_FUSED, _SLOTS = tdescribe.describe_fused, tdescribe._describe_slots


def _numpy(feats) -> dict:
    out = {f.name: np.asarray(getattr(feats.keypoints, f.name)) for f in dataclasses.fields(feats.keypoints)}
    out["descriptors"] = np.asarray(feats.descriptors)
    return out


def _check_frame(ref: dict, got: dict):
    n_ref, n_got = int(ref["valid"].sum()), int(got["valid"].sum())
    assert n_ref > 50
    assert abs(n_ref - n_got) <= max(2, 0.02 * n_ref)
    frac, hams = pair_keypoints(ref, got)
    assert frac >= 0.98
    assert hams.mean() <= 3.0


def test_path_a_xla_describe_matches_jax():
    M = 256
    frames = video_sequence(3, H, W, seed=3)
    jcfg = JaxAkazeConfig(describe_backend="xla", patch_backend="pallas", max_keypoints=M)
    jf = jax.jit(lambda im: jax_extract_batch_fn(im, jcfg))(jnp.asarray(frames))
    jm = jax.vmap(lambda *x: jax_match_fn(*x, JaxMatchConfig()))(
        jf.descriptors[:-1], jf.keypoints.valid[:-1], jf.descriptors[1:], jf.keypoints.valid[1:])
    n0 = dict(_build.launches)
    tf = extract_batch(frames, AkazeConfig(describe_backend="xla", max_keypoints=M), device="cpu")
    tm = match(tf.descriptors[:-1], tf.keypoints.valid[:-1], tf.descriptors[1:], tf.keypoints.valid[1:],
               device="cpu")
    assert _build.launches == n0  # device="cpu" runs the plain twins
    ref, got = _numpy(jf), interop.features_to_numpy(tf)
    for b in range(3):
        _check_frame({k: v[b] for k, v in ref.items()}, {k: v[b] for k, v in got.items()})
    acc_ref, acc_got = np.asarray(jm.accepted).sum(axis=1), tm.count().numpy()
    assert (acc_ref > 20).all()
    assert (np.abs(acc_ref - acc_got) <= 0.05 * acc_ref).all()


def test_path_b_extract_fn_matches_jax():
    img = video_sequence(1, H, W, seed=5)[0]
    jf = jax.jit(lambda im: jax_extract_fn(im, JaxAkazeConfig()))(jnp.asarray(img))
    tf = extract_fn(torch.from_numpy(img), AkazeConfig())
    assert tf.descriptors.shape == (1024, 16) and tf.keypoints.x.shape == (1024,)
    ref, got = _numpy(jf), interop.features_to_numpy(tf)
    _check_frame(ref, got)
    v = ref["valid"]
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["class_id"][v], ref["class_id"][v])
    # uint8 input normalises to [0, 1]; a batch is refused.
    u8 = (img * 255).astype(np.uint8)
    a = extract_fn(torch.from_numpy(u8), AkazeConfig())
    b = extract_fn(torch.from_numpy(u8.astype(np.float32) / 255), AkazeConfig())
    assert torch.equal(a.descriptors, b.descriptors)
    with pytest.raises(ValueError):
        extract_fn(torch.from_numpy(video_sequence(2, 96, 128, seed=1)), AkazeConfig())


@pytest.mark.parametrize("backend,branch", [("auto", "fused"), ("fused", "fused"), ("xla", "xla"),
                                            ("pallas", "pallas")])
def test_describe_backend_dispatch(monkeypatch, backend, branch):
    assert tdescribe._describe_backend(AkazeConfig(describe_backend=backend)) == branch
    calls = []
    monkeypatch.setattr(tdescribe, "describe_fused", lambda *a: calls.append("fused") or _FUSED(*a))
    monkeypatch.setattr(tdescribe, "_describe_slots", lambda *a: calls.append("chunked") or _SLOTS(*a))
    frames = video_sequence(2, 96, 128, seed=2)
    feats = extract_batch(frames, AkazeConfig(describe_backend=backend), device="cpu")
    assert calls == ["fused" if branch == "fused" else "chunked"]
    # 1000 slots (not a multiple of 64) take the chunked branch on any backend.
    calls.clear()
    extract_batch(frames, AkazeConfig(describe_backend=backend, max_keypoints=1000), device="cpu")
    assert calls == ["chunked"]
    ref = extract_batch(frames, AkazeConfig(), device="cpu")
    frac, hams = pair_keypoints(*({k: v[0] for k, v in interop.features_to_numpy(f).items()}
                                  for f in (ref, feats)))
    assert frac == 1.0 and hams.max() <= 4
    with pytest.raises(ValueError):
        tdescribe._describe_backend(AkazeConfig(describe_backend="bogus"))


def test_features_from_numpy_defaults_to_the_card():
    feats = extract_fn(torch.from_numpy(video_sequence(1, 96, 128, seed=4)[0]), AkazeConfig())
    arrays = interop.features_to_numpy(feats)
    if torch.cuda.is_available():
        assert interop.features_from_numpy(arrays).descriptors.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.features_from_numpy(arrays)
    back = interop.features_from_numpy(arrays, device="cpu")
    assert torch.equal(back.descriptors, feats.descriptors)
