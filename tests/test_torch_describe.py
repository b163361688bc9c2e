"""PyTorch port's describe (orientation + M-LDB) against the JAX package's
fused describe kernel in interpret mode and its XLA describe, on the same
stacks and keypoints as tests/test_describe_fused.py.

Gates: angles within 1e-5 rad (wrapped at 2 pi), Hamming mean <= 3 and max
<= 12 bits over valid slots, invalid slots exactly zero."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.frontend.describe import describe as jax_describe
from akaze_tpu.frontend.detect import detect as jax_detect
from akaze_tpu.frontend.pipeline import _statics as jax_statics
from akaze_tpu.frontend.scale_space import build_scale_space
from akaze_tpu.kernels.describe_fused import describe_fused
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels.describe import describe
from torch_port_helpers import hamming, wrapped_angle_diff

torch.set_num_threads(2)

H, W = 240, 320
_FIELDS = ("x", "y", "response", "size", "octave", "class_id", "angle", "valid")


@pytest.fixture(scope="module")
def scene():
    ss, ds = jax_statics(W, H, JaxAkazeConfig())
    stacks, kps, feats = [], [], []
    for f in video_sequence(2, H, W, seed=3):
        st = build_scale_space(jnp.asarray(f, jnp.float32), ss)
        kp = jax_detect(st["Ldet"], ss)
        stacks.append(st)
        kps.append(kp)
        feats.append(jax_describe(kp, st, ss, ds))
    return ss, ds, stacks, kps, feats


def _port_inputs(stacks, kps, valid=None):
    """Per-octave level-major (n, B, h, w) stacks and (B, M) keypoints."""
    tss, tds = _statics(W, H, AkazeConfig())
    lvl_oct = []
    for l0, n, h, w in tss.groups:
        lvl_oct.append({
            key: torch.from_numpy(np.stack([np.asarray(s[key])[l0 : l0 + n, :h, :w] for s in stacks], axis=1))
            for key in ("Lt", "Lx", "Ly")
        })
    fields = {f: torch.from_numpy(np.stack([np.asarray(getattr(k, f)) for k in kps])) for f in _FIELDS}
    if valid is not None:
        fields["valid"] = torch.from_numpy(valid)
    return Keypoints(**fields), tuple(lvl_oct), tss, tds


def _check(ang_ref, desc_ref, ang, desc, valid):
    assert valid.sum() > 50
    assert wrapped_angle_diff(ang_ref[valid], ang[valid]).max() < 1e-5
    ham = hamming(desc_ref[valid], desc[valid])
    assert ham.mean() <= 3.0 and ham.max() <= 12
    assert (desc[~valid] == 0).all() and (ang[~valid] == 0).all()


def test_describe_matches_jax_xla_and_fused(scene):
    ss, ds, stacks, kps, feats = scene
    kp, lvl_oct, tss, tds = _port_inputs(stacks, kps)
    ang, desc = (a.numpy() for a in describe(kp, lvl_oct, tss, tds))
    assert desc.dtype == np.int32 and desc.shape == (2, 1024, 16)
    kb = jax.tree.map(lambda *xs: jnp.stack(xs), *kps)
    st = {k: jnp.stack([s[k] for s in stacks]) for k in ("Lt", "Lx", "Ly")}
    fa, fd = describe_fused(kb, st, ss, ds, interpret=True)
    valid = kp.valid.numpy()
    for b in range(2):
        _check(np.asarray(feats[b].keypoints.angle), np.asarray(feats[b].descriptors),
               ang[b], desc[b], valid[b])
        _check(np.asarray(fa[b]), np.asarray(fd[b]), ang[b], desc[b], valid[b])


def test_describe_validity_holes(scene):
    """Invalid slots inside the valid prefix (sub-pixel rejections are not
    compacted) are zeroed, and every valid slot after them is described."""
    ss, ds, stacks, kps, feats = scene
    v = np.stack([np.asarray(k.valid) for k in kps])
    n_valid = int(v[0].sum())
    holes = [h for h in [3, 5] + list(range(8, 16)) if h < n_valid - 4]
    v_holed = v.copy()
    v_holed[0, holes] = False
    kp, lvl_oct, tss, tds = _port_inputs(stacks, kps, valid=v_holed)
    ang, desc = (a.numpy() for a in describe(kp, lvl_oct, tss, tds))
    kb = dataclasses.replace(jax.tree.map(lambda *xs: jnp.stack(xs), *kps), valid=jnp.asarray(v_holed))
    st = {k: jnp.stack([s[k] for s in stacks]) for k in ("Lt", "Lx", "Ly")}
    fa, fd = describe_fused(kb, st, ss, ds, interpret=True)
    _check(np.asarray(fa[0]), np.asarray(fd[0]), ang[0], desc[0], v_holed[0])
    assert (desc[0][holes] == 0).all()
    tail = v_holed[0].copy()
    tail[: max(holes) + 1] = False
    assert tail.sum() >= 8 and (desc[0][tail] != 0).any(axis=-1).all()
