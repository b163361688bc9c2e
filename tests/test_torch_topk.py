"""The detector's per-level candidate top-K (`kernels/topk.py`,
`csrc/topk.cu`).

On the CPU the wrapper runs the plain form; the plain form equals an
independent numpy sort of every (level, frame) plane by (order-preserving
score bits descending, index ascending) at VGA, KITTI (odd widths, a
47x155 octave) and a frame whose coarse octaves hold fewer pixels than K,
on score planes that hold ties, NaN of both signs, infinities, signed
zeros, values below NEG and planes of NEG alone; the wrapper refuses
malformed stacks.  On the card (`gpu`-marked, skipping without one) the
kernel's five leaves equal the plain form's bit for bit on the same kinds
of planes, chosen to reach all three of its paths, at those shapes and at
3072x2048 with K = 2,048, and on real candidates; its path counts and
launches are checked with them.  The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_topk.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.detect import find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels import _build, topk
from akaze_tpu_torch.kernels.fed import NEG, build_scale_space, octave_groups
from torch_port_helpers import cuda  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.scenes.textured_pan import textured_scene  # noqa: E402

LEAVES = ("resp", "yi", "xi", "flat", "valid")
NEG32 = np.float32(NEG)
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
SPECIAL = np.array([np.nan, NEG_NAN, np.inf, -np.inf, 0.0, -0.0, -3.4e38, 1e-45, 0.5, 0.5], np.float32)

#: (name, height, width, frames, per_level_candidates)
SHAPES = {
    "vga": (480, 640, 2, 256),
    "kitti": (376, 1241, 2, 256),
    "short_octaves": (160, 200, 2, 2048),  # octave 2, 40x50 px, holds fewer than K
    "stills": (2048, 3072, 1, 2048),
}
KINDS = ("sparse", "cut", "dense", "empty", "ties", "special")


def _score_stacks(kind: str, ss, B: int, seed: int) -> list:
    """Per-octave (n, B, h, w) float32 score stacks of made-up planes: NEG
    everywhere but at m pixels per plane.  "sparse": m < k, values from
    four (ties); "cut": k < m <= 4 k, normal values; "dense": every pixel;
    "empty": none; "ties": m > k, all 0.5; "special": per plane either few
    entries (some below NEG: the general path) or more than k, drawn from
    NaN of both signs, infinities, signed zeros, a denormal and values
    below NEG."""
    rng = np.random.default_rng(seed)
    K = ss.config.per_level_candidates
    out = []
    for _, n, h, w in octave_groups(ss):
        hw = h * w
        k = min(K, hw)
        planes = np.full((n * B, hw), NEG32, np.float32)
        for plane in planes:
            if kind == "empty":
                continue
            if kind == "dense":
                plane[:] = rng.standard_normal(hw).astype(np.float32)
                continue
            few = kind == "sparse" or (kind == "special" and rng.random() < 0.5)
            m = int(rng.integers(0, k // 2 + 1 if kind == "special" else k)) if few else int(
                rng.integers(k + 1, (4 if kind == "cut" else 2) * k + 1))
            at = rng.choice(hw, min(m, hw), replace=False)
            if kind == "sparse":
                plane[at] = rng.choice(np.array([0.5, 0.25, 0.125, 0.0625], np.float32), at.size)
            elif kind == "cut":
                plane[at] = rng.standard_normal(at.size).astype(np.float32)
            elif kind == "ties":
                plane[at] = 0.5
            else:
                plane[at] = rng.choice(SPECIAL, at.size)
        out.append(torch.from_numpy(planes.reshape(n, B, h, w)))
    return out


def _reference(stacks, ss) -> dict:
    """numpy: each plane sorted by (ordered bits desc, index asc), the
    first k kept, NEG at index 0 after."""
    K, w0 = ss.config.per_level_candidates, ss.w0
    B = stacks[0].shape[1]
    L = ss.num_levels
    resp = np.full((B, L, K), NEG32, np.float32)
    idx = np.zeros((B, L, K), np.int64)
    ws = np.zeros(L, np.int64)
    for (l0, n, h, w), s in zip(octave_groups(ss), stacks):
        ws[l0 : l0 + n] = w
        k = min(K, h * w)
        planes = s.numpy().reshape(n, B, h * w)
        bits = planes.view(np.int32).astype(np.int64)
        ordered = np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
        for j in range(n):
            for b in range(B):
                order = np.lexsort((np.arange(h * w), -ordered[j, b]))[:k]
                resp[b, l0 + j, :k] = planes[j, b, order]
                idx[b, l0 + j, :k] = order
    yi = (idx // ws[None, :, None]).astype(np.int32)
    xi = (idx % ws[None, :, None]).astype(np.int32)
    return {"resp": resp, "yi": yi, "xi": xi, "flat": yi * np.int32(w0) + xi, "valid": resp > NEG32}


def _expected_paths(stacks, ss) -> dict:
    """Planes by path under the kernel's rule, from the planes' counts
    above and below NEG."""
    K = ss.config.per_level_candidates
    cap = topk.capacity(K)
    neg_bits = np.int64(NEG32.view(np.int32))
    got = dict.fromkeys(topk.PATHS, 0)
    for s in stacks:
        n, B, h, w = s.shape
        k = min(K, h * w)
        bits = s.cpu().numpy().reshape(n * B, h * w).view(np.int32).astype(np.int64)
        ordered = np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
        key_neg = neg_bits ^ 0x7FFFFFFF
        above = (ordered > key_neg).sum(-1)
        below = (ordered < key_neg).sum(-1)
        fast = (above <= cap) & ((above >= k) | (below == 0))
        got["fast"] += int(fast.sum())
        got["cut"] += int((fast & (above > k)).sum())
        got["general"] += int((~fast).sum())
    return got


def _assert_equal(got: dict, ref: dict) -> None:
    for name in LEAVES:
        g, r = got[name], ref[name]
        if name == "resp":
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), name


def _statics_of(shape: str):
    height, width, B, K = SHAPES[shape]
    ss, _ = _statics(width, height, AkazeConfig(per_level_candidates=K))
    return ss, B


@pytest.mark.parametrize("kind", ["sparse", "cut", "special", "empty"])
@pytest.mark.parametrize("shape", ["vga", "kitti", "short_octaves"])
def test_plain_form_equals_numpy_sort(shape, kind):
    ss, B = _statics_of(shape)
    B = 1 if shape != "short_octaves" else B
    stacks = _score_stacks(kind, ss, B, seed=len(shape) * 7 + KINDS.index(kind))
    if shape == "short_octaves":
        assert any(h * w < ss.config.per_level_candidates for _, _, h, w in octave_groups(ss))
    if shape == "kitti":
        assert any(h * w % 4 for _, _, h, w in octave_groups(ss))
    got = topk.per_level_topk(stacks, ss)
    _assert_equal(got, {k: torch.from_numpy(v) for k, v in _reference(stacks, ss).items()})
    _assert_equal(find_candidates_oct([{"score": s} for s in stacks], ss), got)


def test_capacity():
    for K in (1, 37, 256, 511, 512, 1100, 2048, 4096, 5000, 16384, 20000):
        c = topk.capacity(K)
        assert c & (c - 1) == 0 and c >= max(2048, K, min(4 * K, 16384)), (K, c)
    assert topk.capacity(256) == 2048 and topk.capacity(2048) == 8192


@pytest.mark.parametrize("fault", ["dtype", "not_contiguous", "octave_shape", "frames", "octave_count"])
def test_wrapper_refuses(fault):
    ss, B = _statics_of("short_octaves")
    stacks = _score_stacks("sparse", ss, B, seed=3)
    if fault == "dtype":
        stacks[1] = stacks[1].double()
    elif fault == "not_contiguous":
        stacks[0] = stacks[0].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "octave_shape":
        stacks[2] = stacks[2][..., :-1].contiguous()
    elif fault == "frames":
        stacks[1] = stacks[1][:, :-1].contiguous()
    else:
        stacks = stacks[:-1]
    with pytest.raises(ValueError, match="per_level_topk"):
        topk.per_level_topk(stacks, ss)


# ----------------------------------------------------------------- on the card


def _kernel_equals_plain(stacks, ss) -> dict:
    n0 = _build.launches["topk"]
    got = topk.per_level_topk(stacks, ss)
    torch.cuda.synchronize()
    assert _build.launches["topk"] == n0 + 1
    _assert_equal(got, topk.per_level_topk_plain(stacks, ss))
    return topk.path_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernel_equals_plain_synthetic(cuda, shape, kind):
    ss, B = _statics_of(shape)
    stacks = [s.to(cuda) for s in _score_stacks(kind, ss, B, seed=len(shape) * 7 + KINDS.index(kind))]
    paths = _kernel_equals_plain(stacks, ss)
    want = _expected_paths(stacks, ss)
    assert paths == want, (paths, want)
    assert want["fast"] + want["general"] == B * ss.num_levels
    if kind == "dense":
        assert want["general"] > 0
    elif kind in ("cut", "ties"):
        assert want["cut"] > 0 and want["general"] == 0
    elif kind == "special":
        assert want["general"] > 0 and want["fast"] > 0
    else:
        assert want["general"] == 0


@pytest.mark.gpu
def test_kernel_on_an_unaligned_stack(cuda):
    """Stacks that start off a 16-byte boundary: every plane has a scalar
    head and tail."""
    ss, B = _statics_of("kitti")
    stacks = []
    for s in _score_stacks("special", ss, B, seed=5):
        buf = torch.empty(s.numel() + 1, dtype=torch.float32, device=cuda)
        view = buf[1:].view(s.shape)
        view.copy_(s)
        assert view.data_ptr() % 16 == 4
        stacks.append(view)
    _kernel_equals_plain(stacks, ss)


REAL = [("vga", 4, 480, 640, 256), ("kitti", 2, 376, 1241, 256), ("stills", 1, 2048, 3072, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,height,width,K", REAL, ids=[r[0] for r in REAL])
def test_kernel_equals_plain_real(cuda, name, n, height, width, K):
    """Kernel 2's score fields of textured frames, the cells' shapes."""
    ss, _ = _statics(width, height, AkazeConfig(per_level_candidates=K))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    imgs = torch.stack([textured_scene(height, width, gen, cuda) for _ in range(n)])
    fields = build_scale_space(imgs, ss)["oct"]
    paths = _kernel_equals_plain([f["score"] for f in fields], ss)
    assert paths["general"] == 0 and paths["fast"] == n * ss.num_levels, paths
    n0 = _build.launches["topk"]
    cand = find_candidates_oct(fields, ss)
    assert _build.launches["topk"] == n0 + 1 and bool(cand["valid"].any())


@pytest.mark.gpu
def test_no_frames_no_launch(cuda):
    ss, _ = _statics_of("vga")
    stacks = [s[:, :0].to(cuda) for s in _score_stacks("empty", ss, 1, seed=0)]
    n0 = _build.launches["topk"]
    got = topk.per_level_topk(stacks, ss)
    assert got["resp"].shape == (0, ss.num_levels, ss.config.per_level_candidates)
    assert _build.launches["topk"] == n0
