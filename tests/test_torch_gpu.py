"""The port's four CUDA kernels against their plain PyTorch twins on the
card, and the whole path through the kernels against the path through the
twins.  Every test needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import math

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig
from akaze_tpu_torch.frontend.detect import detect, find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn
from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.describe import describe, describe_plain
from akaze_tpu_torch.kernels.fed import (
    base_stage, base_stage_plain, fused_octave, fused_octave_plain, octave_groups, unpack_sub,
)
from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain
from akaze_tpu_torch.matching.hamming import match_fn
from akaze_tpu_torch.utils.synthetic import video_sequence
from torch_port_helpers import cuda, hamming, pair_keypoints  # noqa: F401 (fixture)

pytestmark = pytest.mark.gpu

H, W = 240, 320
# 97 x 131 leaves ragged tiles in every kernel and odd octave sizes (the
# half-size drops a trailing row and column).
SIZES = [(240, 320), (97, 131)]


def _frames(cuda, n=3, seed=4, size=(H, W)):
    return torch.from_numpy(video_sequence(n, *size, seed=seed)).to(cuda)


def _plain_octaves(imgs, ss):
    cfg = ss.config
    seed, modg = base_stage_plain(imgs, cfg.base_scale_offset)
    k = contrast_factor_from_modg(modg, cfg)
    args = []
    groups = octave_groups(ss)
    outs = []
    for oi, (l0, n, _, _) in enumerate(groups):
        if oi:
            k = k * cfg.contrast_octave_decay
        a = (seed, k, tuple(ss.specs[l0 : l0 + n]), cfg.diffusivity, oi == 0,
             float(cfg.detector_threshold), oi + 1 < len(groups))
        out = fused_octave_plain(*a)
        args.append(a)
        outs.append(out)
        seed = out[5]
    return args, outs


@pytest.mark.parametrize("size", SIZES)
def test_base_stage_kernel(cuda, size):
    imgs = _frames(cuda, size=size)
    n0 = _build.launches["base_stage"]
    got = base_stage(imgs, 1.6)
    assert _build.launches["base_stage"] == n0 + 1
    for g, r in zip(got, base_stage_plain(imgs, 1.6)):
        assert (g - r).abs().max().item() <= 2e-5


@pytest.mark.parametrize("size", SIZES)
def test_fused_octave_kernel(cuda, size):
    ss, _ = _statics(size[1], size[0], AkazeConfig())
    args, outs = _plain_octaves(_frames(cuda, size=size), ss)
    for a, ref in zip(args, outs):
        got = fused_octave(*a)
        for g, r in zip(got[:3], ref[:3]):
            assert (g - r).abs().max().item() <= 2e-5
        cand = ref[3] > -1e38
        assert torch.equal(cand, got[3] > -1e38)
        assert torch.allclose(got[3], ref[3], atol=2e-6, rtol=1e-6)
        oxg, oyg, kg = unpack_sub(got[4])
        oxr, oyr, kr = unpack_sub(ref[4])
        assert torch.equal(kg[cand], kr[cand])
        both = cand & kg
        assert torch.allclose(oxg[both], oxr[both], atol=1e-4)
        assert torch.allclose(oyg[both], oyr[both], atol=1e-4)
        if ref[5] is not None:
            assert (got[5] - ref[5]).abs().max().item() <= 2e-5


def test_describe_kernel(cuda):
    ss, ds = _statics(W, H, AkazeConfig())
    _, outs = _plain_octaves(_frames(cuda), ss)
    lvl_oct = tuple({"Lt": o[0], "Lx": o[1], "Ly": o[2]} for o in outs)
    fields = tuple({"score": o[3], "sub": o[4]} for o in outs)
    kps = detect(find_candidates_oct(fields, ss), fields, ss)
    kps.valid[0, 3:12] = False  # holes inside the valid prefix
    ang_k, desc_k = describe(kps, lvl_oct, ss, ds)
    ang_p, desc_p = describe_plain(kps, lvl_oct, ss, ds)
    v = kps.valid
    d = (ang_k - ang_p).abs()[v]
    assert torch.minimum(d, 2 * math.pi - d).max().item() <= 1e-5
    ham = hamming(desc_k[v].cpu().numpy(), desc_p[v].cpu().numpy())
    assert ham.mean() <= 3 and ham.max() <= 12
    assert (desc_k[~v] == 0).all() and (ang_k[~v] == 0).all()


def test_match_kernel(cuda):
    rng = np.random.default_rng(3)
    P, Ka, Kb = 3, 300, 260
    a = rng.integers(-2**31, 2**31, size=(P, Ka, 16), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, size=(P, Kb, 16), dtype=np.int64).astype(np.int32)
    b[:, :100] = a[:, :100]
    a[:, 200:] = a[:, :100]  # duplicate rows: ties
    va = rng.random((P, Ka)) > 0.1
    vb = rng.random((P, Kb)) > 0.1
    vb[2] = False  # a pair with no valid B
    t = lambda x: torch.from_numpy(x).to(cuda)
    got = match_reduce(t(a), t(va), t(b), t(vb))
    ref = match_reduce_plain(t(a), t(va), t(b), t(vb))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("size", SIZES)
def test_whole_path_kernels_vs_plain(cuda, size):
    frames = _frames(cuda, n=2, seed=7, size=size)
    fk = extract_batch(frames, device=cuda)
    fp = extract_batch_fn(frames, AkazeConfig(), plain=True)
    for f in range(2):
        to_np = lambda feats: {**{k: getattr(feats.keypoints, k)[f].cpu().numpy()
                                  for k in ("x", "y", "class_id", "valid")},
                               "descriptors": feats.descriptors[f].cpu().numpy()}
        frac, hams = pair_keypoints(to_np(fp), to_np(fk))
        assert frac >= 0.98 and hams.mean() <= 3
    cfg = MatchConfig()
    mk = match_fn(fk.descriptors[:1], fk.keypoints.valid[:1], fk.descriptors[1:], fk.keypoints.valid[1:], cfg)
    mp = match_fn(fp.descriptors[:1], fp.keypoints.valid[:1], fp.descriptors[1:], fp.keypoints.valid[1:], cfg,
                  plain=True)
    assert abs(int(mk.count().sum()) - int(mp.count().sum())) <= 0.05 * int(mp.count().sum())


def test_flat_frames_through_the_kernels(cuda):
    """No keypoint anywhere: every describe slot and every match row takes
    its invalid branch."""
    frames = torch.full((2, 97, 131), 0.5, device=cuda)
    feats = extract_batch(frames, device=cuda)
    assert int(feats.keypoints.count().sum()) == 0
    assert (feats.descriptors == 0).all() and (feats.keypoints.angle == 0).all()
    m = match_fn(feats.descriptors[:1], feats.keypoints.valid[:1], feats.descriptors[1:],
                 feats.keypoints.valid[1:], MatchConfig())
    assert not m.accepted.any() and (m.distance == 1 << 30).all() and (m.idx_b == 0).all()
