"""PyTorch port's detection (exact per-level top-K, symmetric cross-level
NMS, top-M, packed sub-pixel refinement) against the JAX package's
`detect(None, st, cand=find_candidates_oct(...), subpix_oct=...)` on the
same score / sub fields: equal `valid` and `class_id`, and x / y /
response within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.frontend import detect as jdet
from akaze_tpu.frontend.scale_space import ScaleSpaceStatics as JaxStatics
from akaze_tpu.kernels.fed_pallas import build_scale_space_pallas_batched
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend import detect as tdet
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics

torch.set_num_threads(2)

H, W = 240, 320


@pytest.fixture(scope="module")
def fields():
    """JAX per-octave score / packed sub fields of two frames (the XLA
    octave path of the batched builder: pallas_octaves=0)."""
    jst = JaxStatics(W, H, JaxAkazeConfig(pallas_octaves=0))
    imgs = jnp.asarray(video_sequence(2, H, W, seed=3))
    out = jax.jit(lambda im: build_scale_space_pallas_batched(im, jst, with_detect=True))(imgs)
    return [{k: np.asarray(v) for k, v in o.items()} for o in out["oct"]]


def _jax_detect(oct_np, size=(W, H)):
    jst = JaxStatics(*size, JaxAkazeConfig(pallas_octaves=0))
    oct_j = tuple({k: jnp.asarray(v) for k, v in o.items()} for o in oct_np)
    cand = jdet.find_candidates_oct(oct_j, jst)
    oct_axes = jax.tree.map(lambda _: 1, oct_j)
    kps = jax.vmap(lambda o, c: jdet.detect(None, jst, cand=c, subpix_oct=o), in_axes=(oct_axes, 0))(
        oct_j, cand
    )
    return {f: np.asarray(getattr(kps, f)) for f in ("x", "y", "response", "class_id", "valid")}


def _port_detect(oct_np, size=(W, H)):
    st = ScaleSpaceStatics(*size, AkazeConfig())
    oct_t = tuple({k: torch.from_numpy(v.copy()) for k, v in o.items()} for o in oct_np)
    kps = tdet.detect(tdet.find_candidates_oct(oct_t, st), oct_t, st)
    return {f: getattr(kps, f).numpy() for f in ("x", "y", "response", "class_id", "valid")}


def _assert_same(ref, got, slots=None):
    """Equal valid masks; class_id, x, y, response equal on `slots` (all
    slots by default)."""
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    s = np.ones_like(ref["valid"]) if slots is None else slots
    np.testing.assert_array_equal(got["class_id"][s], ref["class_id"][s])
    for f in ("x", "y", "response"):
        np.testing.assert_allclose(got[f][s], ref[f][s], atol=1e-6, rtol=0, err_msg=f)


def test_detect_matches_jax(fields):
    ref, got = _jax_detect(fields), _port_detect(fields)
    assert ref["valid"].sum(axis=1).min() > 50
    _assert_same(ref, got)


def test_detect_frame_smaller_than_candidate_cap():
    """A 14 x 18 frame has fewer pixels (252) than per_level_candidates
    (256): the per-level top-K pads with sentinel slots, as the JAX
    per-octave path does.  Only valid slots are compared: when k equals
    the row length, approx_max_k orders the sentinel ties arbitrarily."""
    jst = JaxStatics(18, 14, JaxAkazeConfig(pallas_octaves=0))
    imgs = jnp.asarray(video_sequence(2, 120, 160, seed=9)[:, 40:54, 60:78])
    out = jax.jit(lambda im: build_scale_space_pallas_batched(im, jst, with_detect=True))(imgs)
    oct_np = [{k: np.asarray(v) for k, v in o.items()} for o in out["oct"]]
    ref, got = _jax_detect(oct_np, (18, 14)), _port_detect(oct_np, (18, 14))
    assert got["valid"].shape == (2, 1024)
    _assert_same(ref, got, slots=ref["valid"])


@pytest.mark.parametrize("mode", ["planted", "all_equal"])
def test_detect_response_ties(fields, mode):
    """Exact response ties must be broken like lax.top_k, the lower index
    first: "planted" copies one candidate's response onto two others of the
    same frame (same level far apart, and other levels); "all_equal" gives
    every candidate the same response, so ties also straddle the cuts."""
    oct_np = [{k: v.copy() for k, v in o.items()} for o in fields]
    score = oct_np[0]["score"]  # (n, B, h, w)
    if mode == "planted":
        lv, fr, ys, xs = np.nonzero(score > -1e38)
        for f in range(score.shape[1]):
            idx = np.nonzero(fr == f)[0]
            assert len(idx) >= 8
            a, b, c = idx[0], idx[-1], idx[len(idx) // 2]
            value = score[lv[a], f, ys[a], xs[a]]
            score[lv[b], f, ys[b], xs[b]] = value
            score[lv[c], f, ys[c], xs[c]] = value
    else:
        for o in oct_np:
            o["score"][o["score"] > -1e38] = np.float32(0.01)
    ref, got = _jax_detect(oct_np), _port_detect(oct_np)
    if mode == "all_equal":
        assert len(np.unique(ref["response"][ref["valid"]])) == 1
    _assert_same(ref, got)
