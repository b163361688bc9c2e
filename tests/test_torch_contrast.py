"""The contrast factor (`kernels/contrast.py`, `csrc/contrast.cu`).

On the CPU the wrapper refuses malformed planes and runs the plain form
(`frontend/scale_space.contrast_factor_from_modg`), and the plain form
agrees with the golden model's numpy bincount (`golden/akaze.py`
`compute_contrast_factor`, fed the planes as its |grad|) on an all-zero
frame, a constant frame, a single non-zero pixel, values on the bin edges,
every pixel in the top bin and textured planes: the same bin, so k to the
float32 rounding of the golden's float64 product.  On the card
(`gpu`-marked, skipping without one) the kernel's k equals the plain form's
bit for bit at the cells' shapes (128 x 480 x 640, 128 x 376 x 1241 with
unaligned rows, 2 x 2048 x 3072), at B = 1, and on those edge frames plus
NaN, inf and negative ones; its path counts name the fallback frames; the
stage and the scale space run under `set_sync_debug_mode("error")`.  The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_contrast.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
from akaze_tpu_torch.golden import akaze as gold
from akaze_tpu_torch.kernels import _build, contrast
from akaze_tpu_torch.kernels.fed import base_stage, build_scale_space, build_scale_space_levels
from akaze_tpu_torch.utils.synthetic import video_sequence
from torch_port_helpers import cuda  # noqa: F401 (a fixture)

CFG = AkazeConfig()
#: Frames whose k needs the histogram, and those the golden model takes
#: (it has no NaN or inf rule of its own).
FINITE_KINDS = ("zero", "constant", "single", "bin_edges", "top_bin", "textured")
KINDS = FINITE_KINDS + ("nan", "inf", "negative")
FALLBACK_KINDS = ("zero", "negative")


def _plane(kind: str, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """One (h, w) float32 |grad|-like plane of the named kind; the 1-px
    frame holds values the interior must not see."""
    p = np.zeros((h, w), np.float32)
    inner = p[1:-1, 1:-1]
    n = inner.size
    if kind == "constant":
        inner[:] = np.float32(0.37)
    elif kind == "single":
        inner[rng.integers(0, h - 2), rng.integers(0, w - 2)] = np.float32(0.25)
    elif kind == "bin_edges":
        # m = safe * j / nbins for every bin j, the maximum 1.7 placed once.
        j = rng.integers(0, CFG.contrast_nbins, n)
        inner.flat[:] = (np.float32(1.7) * j.astype(np.float32)) / np.float32(CFG.contrast_nbins)
        inner.flat[rng.integers(0, n)] = np.float32(1.7)
    elif kind == "top_bin":
        # Every non-zero pixel in bin nbins - 1: within 1/nbins of the maximum.
        inner.flat[:] = np.float32(0.8) * (1 - rng.random(n, dtype=np.float32) / np.float32(400))
        inner.flat[0] = np.float32(0.8)
    elif kind == "textured":
        inner.flat[:] = rng.random(n, dtype=np.float32) ** 2
        inner.flat[rng.random(n) < 0.1] = 0
    elif kind == "nan":
        inner.flat[:] = rng.random(n, dtype=np.float32)
        inner.flat[rng.integers(0, n, 3)] = np.nan
        inner.flat[rng.integers(0, n)] = -np.float32(np.nan)
    elif kind == "inf":
        inner.flat[:] = rng.random(n, dtype=np.float32)
        inner.flat[rng.integers(0, n, 2)] = np.inf
    elif kind == "negative":
        inner.flat[:] = -rng.random(n, dtype=np.float32)
    # The frame is not interior: a value it holds must change nothing.
    p[0, :] = p[-1, :] = p[:, 0] = p[:, -1] = np.float32(9.0)
    return p


def _golden_k(plane: np.ndarray, monkeypatch) -> float:
    """The golden model's k with `plane` as its |grad|: its blur and
    derivatives replaced by the identity and zero, so its
    sqrt(lx^2 + ly^2) is the plane itself."""
    with monkeypatch.context() as m:
        m.setattr(gold, "gaussian_blur", lambda img, sigma: img)
        m.setattr(gold, "scharr", lambda img, xo, yo, size=1: img if xo == 1 else np.zeros_like(img))
        return gold.compute_contrast_factor(plane, CFG)


# ----------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("fault", ["dtype", "rank_2", "rank_4", "not_contiguous"])
def test_wrapper_refuses(fault):
    modg = torch.rand((2, 20, 30))
    if fault == "dtype":
        modg = modg.double()
    elif fault == "rank_2":
        modg = modg[0]
    elif fault == "rank_4":
        modg = modg[None]
    else:
        modg = modg.transpose(1, 2)
    with pytest.raises(ValueError, match="contrast_factor"):
        contrast.contrast_factor(modg, CFG)


@pytest.mark.parametrize("kind", FINITE_KINDS)
@pytest.mark.parametrize("size", [(20, 30), (37, 53)])
def test_plain_form_agrees_with_golden(kind, size, monkeypatch):
    plane = _plane(kind, *size, np.random.default_rng(len(kind) * 31 + size[1]))
    want = _golden_k(plane, monkeypatch)
    got = contrast_factor_from_modg(torch.from_numpy(plane)[None], CFG)
    assert got.shape == (1,) and got.dtype == torch.float32
    got = float(got[0])
    if kind in FALLBACK_KINDS:
        assert want == CFG.contrast_fallback and got == np.float32(CFG.contrast_fallback)
    # Another bin would move k by hmax / nbins, far more than one ulp.
    assert abs(got - want) <= np.spacing(np.float32(want)), (kind, got, want)


def test_wrapper_runs_the_plain_form_on_cpu(monkeypatch):
    """A batch of every finite kind at once: each frame's k is its own,
    the wrapper's equals the plain form's, and it launches nothing."""
    rng = np.random.default_rng(5)
    planes = np.stack([_plane(kind, 37, 53, rng) for kind in FINITE_KINDS])
    n0 = _build.launches["contrast"]
    got = contrast.contrast_factor(torch.from_numpy(planes), CFG)
    assert _build.launches["contrast"] == n0
    assert torch.equal(got, contrast_factor_from_modg(torch.from_numpy(planes), CFG))
    for plane, k in zip(planes, got.tolist()):
        want = _golden_k(plane, monkeypatch)
        assert abs(k - want) <= np.spacing(np.float32(want))


def test_tile_count():
    sms = 132
    assert contrast.tile_count(128, 480, 640, sms) == 9  # 1,152 blocks
    assert contrast.tile_count(30, 2048, 3072, sms) == 36
    assert contrast.tile_count(1, 480, 640, sms) == 37  # capped by the tile's pixels
    assert contrast.tile_count(4, 20, 30, sms) == 1
    assert contrast.tile_count(4096, 480, 640, sms) == 1


# ----------------------------------------------------------------- on the card


def _assert_kernel_equals_plain(modg, config=CFG):
    n0 = _build.launches["contrast"]
    got = contrast.contrast_factor(modg, config)
    torch.cuda.synchronize()
    assert _build.launches["contrast"] == n0 + 1
    want = contrast_factor_from_modg(modg, config)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (got - want).abs().max()
    return got


def _random_modg(cuda, B, H, W, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    m = torch.rand((B, H, W), generator=gen, device=cuda) ** 4
    return torch.where(torch.rand((B, H, W), generator=gen, device=cuda) < 0.05, 0.0, m)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 480, 640), (128, 376, 1241), (2, 2048, 3072), (1, 480, 640), (1, 97, 131)])
def test_kernel_equals_plain_at_the_cells_shapes(cuda, shape):
    modg = _random_modg(cuda, *shape, seed=shape[2])
    k = _assert_kernel_equals_plain(modg)
    assert contrast.path_counts() == {"percentile": shape[0], "fallback": 0}
    assert (k > 0).all()


@pytest.mark.gpu
def test_kernel_equals_plain_on_kernel_1s_planes(cuda):
    for H, W in ((480, 640), (376, 1241)):
        imgs = torch.from_numpy(video_sequence(4, H, W, seed=W)).to(cuda)
        _assert_kernel_equals_plain(base_stage(imgs, CFG.base_scale_offset)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(20, 30), (37, 53), (480, 640), (376, 1241)])
def test_kernel_equals_plain_on_edge_frames(cuda, size):
    """Every kind in one batch, then each alone (B = 1); the counter names
    the frames that fell back."""
    rng = np.random.default_rng(size[1])
    planes = np.stack([_plane(kind, *size, rng) for kind in KINDS])
    modg = torch.from_numpy(planes).to(cuda)
    _assert_kernel_equals_plain(modg)
    n_fallback = sum(kind in FALLBACK_KINDS for kind in KINDS)
    assert contrast.path_counts() == {"percentile": len(KINDS) - n_fallback, "fallback": n_fallback}
    for kind, plane in zip(KINDS, modg):
        _assert_kernel_equals_plain(plane[None].contiguous())
        fell_back = kind in FALLBACK_KINDS
        assert contrast.path_counts() == {"percentile": int(not fell_back), "fallback": int(fell_back)}, kind


@pytest.mark.gpu
def test_configuration_reaches_the_kernel(cuda):
    """nbins, the percentile and the fallback are launch arguments: other
    values give the plain form's k (1,536 bins and more take more than the
    default 48 KB of shared memory), and a percentile above 1 makes every
    frame fall back."""
    modg = _random_modg(cuda, 8, 97, 131, seed=3)
    for config in (dataclasses.replace(CFG, contrast_nbins=37, contrast_percentile=0.3),
                   dataclasses.replace(CFG, contrast_nbins=1536),
                   dataclasses.replace(CFG, contrast_nbins=contrast.MAX_BINS, contrast_percentile=0.95),
                   dataclasses.replace(CFG, contrast_nbins=1)):
        _assert_kernel_equals_plain(modg, config)
    k = _assert_kernel_equals_plain(modg, dataclasses.replace(CFG, contrast_percentile=1.5, contrast_fallback=0.5))
    assert (k == 0.5).all() and contrast.path_counts() == {"percentile": 0, "fallback": 8}


@pytest.mark.gpu
def test_stage_and_scale_space_issue_no_host_sync(cuda):
    imgs = torch.from_numpy(video_sequence(4, 480, 640, seed=8)).to(cuda)
    ss, _ = _statics(640, 480, CFG)
    modg = base_stage(imgs, CFG.base_scale_offset)[1]
    want = contrast.contrast_factor(modg, CFG)
    build_scale_space(imgs, ss)  # loads the libraries
    torch.cuda.synchronize()
    n0 = _build.launches["contrast"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = contrast.contrast_factor(modg, CFG)
        build_scale_space(imgs, ss)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.launches["contrast"] == n0 + 2
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_both_builders_launch_the_kernel(cuda):
    imgs = torch.from_numpy(video_sequence(2, 97, 131, seed=2)).to(cuda)
    ss, _ = _statics(131, 97, CFG)
    for build in (build_scale_space, build_scale_space_levels):
        n0 = _build.launches["contrast"]
        build(imgs, ss)
        assert _build.launches["contrast"] == n0 + 1, build.__name__
        build(imgs, ss, plain=True)
        assert _build.launches["contrast"] == n0 + 1, build.__name__
