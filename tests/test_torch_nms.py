"""The detector's cross-level NMS (`kernels/nms.py`, `csrc/nms.cu`).

On the CPU the wrapper runs the plain form and launches nothing; the plain
form equals an independent numpy loop over (frame, level, neighbour
level) on made-up candidates that hold response ties, NaN and infinite
responses, pairs at exactly the suppression radius, empty levels, B = 1,
one level and more slots than the kernel's block has threads.  On the card
(`gpu`-marked, skipping without one) the kernel's masked responses equal
the plain form's bit for bit on the same cases and on real candidates of
both detection paths, and the wrapper refuses malformed input.  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_nms.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.detect import find_candidates, find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.fed import NEG, build_scale_space, build_scale_space_levels
from akaze_tpu_torch.kernels.nms import cross_level_nms, cross_level_nms_plain
from akaze_tpu_torch.utils.synthetic import textured_scene
from torch_port_helpers import cuda  # noqa: F401 (a fixture)


class _Statics:
    """The fields of ScaleSpaceStatics that the NMS reads, with made-up
    level tables."""

    def __init__(self, ratios, sizes, h0, w0, factor=0.5):
        self.num_levels = len(ratios)
        self.ratios = np.asarray(ratios, np.float32)
        self.sizes = np.asarray(sizes, np.float32)
        self.h0, self.w0 = h0, w0
        self.config = AkazeConfig(dedup_radius_factor=factor)

    def on(self, device):
        """The NMS's (2, L) table as `ScaleSpaceStatics.on` lays it out."""
        r2 = (self.config.dedup_radius_factor * self.sizes) ** 2
        return SimpleNamespace(nms=torch.as_tensor(np.stack([self.ratios, r2]).astype(np.float32), device=device))


def _synthetic(case: str):
    """(candidates as CPU tensors, statics) of a made-up case: per (frame,
    level) K distinct pixels of a small window, so that many pairs lie
    within the radius, and responses from four values (ties) or, in
    "nan_inf", NaN, infinities and signed zeros, all valid."""
    rng = np.random.default_rng(sum(map(ord, case)))
    B, L, K = {"b1": (1, 6, 48), "one_level": (2, 1, 64), "wide_k": (2, 3, 300)}.get(case, (2, 6, 48))
    ratios = [1.0, 1.1, 2.0] if case == "wide_k" else [1.0, 1.0, 2.0, 2.0, 4.0, 4.0][:L]
    sizes = [2.0, 3.1, 5.7, 7.9, 11.0, 16.3][:L]
    window = 24 if case == "wide_k" else 12
    cells = np.stack([np.stack([rng.choice(window * window, K, replace=False) for _ in range(L)])
                      for _ in range(B)])
    xi, yi = cells % window, cells // window
    if case == "radius_edge":
        # Level pixels on a (3, 4) lattice and radii of 5 octave-0 px per
        # unit of ratio: a step of (1, 1) on one level, and of (2, 2) across
        # a doubling of the ratio, lands exactly on the radius (integers, so
        # d2 == r2 holds in float32).
        sizes = [10.0 * r for r in ratios]
        cells = np.stack([np.stack([rng.choice(48, K, replace=False) for _ in range(L)]) for _ in range(B)])
        xi, yi = 3 * (cells % 8), 4 * (cells // 8)
    h0, w0 = 48, 64
    if case == "nan_inf":
        values = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 0.5, 0.25], np.float32)
        resp = rng.choice(values, (B, L, K))
        valid = np.ones((B, L, K), bool)
    else:
        resp = rng.choice(np.array([0.5, 0.25, 0.125, 0.0625], np.float32), (B, L, K))
        valid = rng.random((B, L, K)) < 0.8
        if case == "empty_levels":
            valid[:, [0, 3, L - 1]] = False
        resp = np.where(valid, resp, np.float32(NEG)).astype(np.float32)
    cand = {"resp": torch.from_numpy(resp), "xi": torch.from_numpy(xi.astype(np.int32)),
            "yi": torch.from_numpy(yi.astype(np.int32)), "flat": torch.from_numpy((yi * w0 + xi).astype(np.int32)),
            "valid": torch.from_numpy(valid)}
    return cand, _Statics(ratios, sizes, h0, w0)


SYNTHETIC = ["ties", "nan_inf", "radius_edge", "empty_levels", "b1", "one_level", "wide_k"]


def _reference(cand: dict, st, r2=None) -> np.ndarray:
    """The survivor mask by a numpy loop over frames, levels and their
    neighbour levels, in float32 (r2: the squared radii, by default those
    of `st`)."""
    resp, xi, yi, flat, valid = (cand[k].cpu().numpy() for k in ("resp", "xi", "yi", "flat", "valid"))
    B, L, _ = resp.shape
    ratios = np.asarray(st.ratios, np.float32)
    if r2 is None:
        r2 = np.float32(st.config.dedup_radius_factor) * np.asarray(st.sizes, np.float32)
        r2 = r2 * r2
    npx = st.h0 * st.w0
    keep = valid.copy()
    with np.errstate(invalid="ignore"):
        for b in range(B):
            for l in range(L):
                px, py = xi[b, l].astype(np.float32) * ratios[l], yi[b, l].astype(np.float32) * ratios[l]
                pr, pt = resp[b, l], l * npx + flat[b, l].astype(np.int64)
                for s in range(max(l - 1, 0), min(l + 2, L)):
                    dx = px[:, None] - (xi[b, s].astype(np.float32) * ratios[s])[None, :]
                    dy = py[:, None] - (yi[b, s].astype(np.float32) * ratios[s])[None, :]
                    close = dx * dx + dy * dy <= r2[max(l, s)]
                    qr, qt = resp[b, s][None, :], (s * npx + flat[b, s].astype(np.int64))[None, :]
                    beats = (qr > pr[:, None]) | ((qr == pr[:, None]) & (qt < pt[:, None]))
                    keep[b, l] &= ~(close & beats & valid[b, s][None, :]).any(axis=1)
    return keep


def _masked_bits(keep: torch.Tensor, resp: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, resp, torch.full_like(resp, NEG)).view(torch.int32)


@pytest.mark.parametrize("case", SYNTHETIC)
def test_cpu_wrapper_runs_the_plain_form(case):
    """CPU tensors take the plain form (no launch); it equals the numpy loop,
    and each case both suppresses and keeps valid candidates."""
    cand, st = _synthetic(case)
    n0 = _build.launches["nms"]
    masked = cross_level_nms(cand, st)
    assert _build.launches["nms"] == n0
    ref = _reference(cand, st)
    np.testing.assert_array_equal(cross_level_nms_plain(cand, st).numpy(), ref)
    assert torch.equal(masked.view(torch.int32), _masked_bits(torch.from_numpy(ref), cand["resp"]))
    valid = cand["valid"].numpy()
    assert ref.any() and (valid & ~ref).any()
    if case == "empty_levels":
        assert not ref[:, [0, 3, -1]].any()


def test_radius_edge_case_is_decided_on_the_radius():
    """The radius case holds valid pairs at exactly d2 == r2: with each r2
    one float32 step lower the loop keeps other candidates."""
    cand, st = _synthetic("radius_edge")
    r2 = (np.float32(st.config.dedup_radius_factor) * st.sizes) ** 2
    below = np.nextafter(r2, np.float32(0))
    assert (_reference(cand, st) != _reference(cand, st, r2=below)).any()


def test_wrapper_refuses_an_int32_tie_key():
    """level * h0 * w0 + flat must fit int32, on either form."""
    cand, st = _synthetic("ties")
    st.h0, st.w0 = 20_000, 20_000
    with pytest.raises(ValueError, match="overflows int32"):
        cross_level_nms(cand, st)


def _kernel_equals_plain(cand: dict, st) -> torch.Tensor:
    n0 = _build.launches["nms"]
    masked = cross_level_nms(cand, st)
    torch.cuda.synchronize()
    assert _build.launches["nms"] == n0 + 1
    ref = cross_level_nms_plain(cand, st)
    assert torch.equal(masked.view(torch.int32), _masked_bits(ref, cand["resp"]))
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("case", SYNTHETIC)
def test_kernel_equals_plain_synthetic(cuda, case):
    cand, st = _synthetic(case)
    ref = _kernel_equals_plain({k: v.to(cuda) for k, v in cand.items()}, st)
    np.testing.assert_array_equal(ref.cpu().numpy(), _reference(cand, st))


def _frames(cuda, n, height, width, seed=11):
    return torch.from_numpy(np.stack([textured_scene(height, width, seed=seed + i) for i in range(n)])).to(cuda)


REAL = [
    ("vga", 4, 480, 640, {}),
    ("kitti", 2, 376, 1241, {}),
    ("vga_k64", 2, 480, 640, {"per_level_candidates": 64}),
    ("vga_k1100", 2, 480, 640, {"per_level_candidates": 1100}),
    ("vga_3_octaves", 2, 480, 640, {"num_octaves": 3}),
    ("b1", 1, 480, 640, {}),
    ("below_the_cap", 2, 14, 18, {"detector_threshold": 3e-4}),
]


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["oct", "dense"])
@pytest.mark.parametrize("name,n,height,width,kw", REAL, ids=[r[0] for r in REAL])
def test_kernel_equals_plain_real(cuda, path, name, n, height, width, kw):
    """Candidates of textured scenes on the batch path (per-octave fields,
    octave-0 flat index) and the dense path (padded Ldet, padded index)."""
    cfg = AkazeConfig(**kw)
    ss, _ = _statics(width, height, cfg)
    imgs = _frames(cuda, n, height, width)
    if path == "oct":
        cand = find_candidates_oct(build_scale_space(imgs, ss)["oct"], ss)
    else:
        cand = find_candidates(build_scale_space_levels(imgs, ss)["Ldet"], ss)
    ref = _kernel_equals_plain(cand, ss)
    if name != "below_the_cap":
        assert ref.any() and (cand["valid"] & ~ref).any()


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["dtype", "not_contiguous", "foreign_device", "levels"])
def test_wrapper_refuses(cuda, fault):
    cand, st = _synthetic("ties")
    cand = {k: v.to(cuda) for k, v in cand.items()}
    if fault == "dtype":
        cand["resp"] = cand["resp"].double()
    elif fault == "not_contiguous":
        cand["xi"] = cand["xi"].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "foreign_device":
        cand["flat"] = cand["flat"].cpu()
    else:
        cand = {k: v[:, :-1].contiguous() for k, v in cand.items()}
    n0 = _build.launches["nms"]
    with pytest.raises(ValueError):
        cross_level_nms(cand, st)
    assert _build.launches["nms"] == n0


@pytest.mark.gpu
def test_no_candidates_no_launch(cuda):
    """A batch of no frames gives an empty result and counts no launch."""
    cand, st = _synthetic("ties")
    cand = {k: v[:0].to(cuda) for k, v in cand.items()}
    n0 = _build.launches["nms"]
    assert cross_level_nms(cand, st).shape == cand["resp"].shape
    assert _build.launches["nms"] == n0
