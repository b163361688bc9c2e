"""The detector's per-level candidate top-K: one CUDA launch per call
(`csrc/topk.cu`, after a launch that zeroes its counters) on CUDA tensors,
its plain PyTorch form on CPU tensors.

The inputs are kernel 2's per-octave score stacks, (n, B, h, w) float32
per octave group, NEG wherever a pixel is no candidate.  For each (level,
frame) plane the result holds its k = min(K, h * w) largest scores,
ordered by the order-preserving integer of the score's bits, then by the
lower index (`lax.top_k`'s tie rule, NaN and infinities included), and
NEG at index 0 in the slots past k.  It is the dict of (B, L, K) leaves
that `frontend/detect.py` passes on: "resp", "yi", "xi" (level pixels),
"flat" (yi * w0 + xi, an index into the octave-0 plane, int32) and
"valid" (resp > NEG); the kernel's leaves equal the plain form's bit for
bit.

`path_counts()` reads the latest kernel call's planes by path: "fast"
(the entries above NEG sorted in shared memory), "cut" (of those, planes
with more than k entries), "general" (a radix select over the whole
plane: more than `capacity(K)` entries above NEG, or fewer than k with
some below NEG).  Reading it waits for the card.
"""

from __future__ import annotations

import ctypes

import torch

from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.fed import NEG

#: Most octaves the kernel's launch argument holds.
MAX_OCTAVES = 8
PATHS = ("fast", "cut", "general")

_latest_paths = None  # the latest call's (3,) int32 device sums, in PATHS order


def capacity(K: int) -> int:
    """Entries above NEG a plane may hold and stay on the fast path: a power
    of two, at least 2,048 and at least 4 K up to 16,384, never below K
    (the general path sorts k entries in the same shared memory)."""
    return 1 << (max(2048, min(4 * K, 16384), K) - 1).bit_length()


def topk_stable(values: torch.Tensor, k: int):
    """Top-k along the last axis of float32 `values`, ties to the lower
    index, as (values, indices) sorted best first: `torch.topk` over unique
    int64 keys (order-preserving score bits, then the reversed index)."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)  # float order as int order
    n = values.shape[-1]
    index = torch.arange(n, device=values.device, dtype=torch.int64)
    key = ordered * (1 << 32) + (n - 1 - index)
    idx = torch.topk(key, k, dim=-1, sorted=True).indices
    return torch.gather(values, -1, idx), idx


def topk_padded(values: torch.Tensor, K: int):
    """`topk_stable` of k = min(K, n) along the last axis of length n, the
    slots past k holding NEG at index 0."""
    k = min(K, values.shape[-1])
    resp, idx = topk_stable(values, k)
    if k < K:
        resp = torch.nn.functional.pad(resp, (0, K - k), value=NEG)
        idx = torch.nn.functional.pad(idx, (0, K - k))
    return resp, idx


def per_level_topk_plain(scores, statics) -> dict:
    """Per-level top-K from per-octave level-major (n, B, h, w) score
    stacks through `topk_padded`."""
    K = statics.config.per_level_candidates
    w0 = statics.w0
    resp_g, yi_g, xi_g = [], [], []
    for (_, n, h, w), score in zip(statics.groups, scores):
        B = score.shape[1]
        resp, idx = topk_padded(score.reshape(n * B, h * w), K)
        resp_g.append(resp.reshape(n, B, K).transpose(0, 1))
        yi_g.append(torch.div(idx, w, rounding_mode="floor").reshape(n, B, K).transpose(0, 1))
        xi_g.append((idx % w).reshape(n, B, K).transpose(0, 1))
    resp = torch.cat(resp_g, dim=1)
    yi = torch.cat(yi_g, dim=1).to(torch.int32)
    xi = torch.cat(xi_g, dim=1).to(torch.int32)
    return {"resp": resp, "yi": yi, "xi": xi, "flat": yi * w0 + xi, "valid": resp > NEG}


def _check(scores, groups) -> None:
    if len(scores) != len(groups):
        raise ValueError(f"per_level_topk: {len(groups)} octave stacks expected, got {len(scores)}")
    dev, B = scores[0].device, scores[0].shape[1] if scores[0].ndim == 4 else None
    for o, (s, (_, n, h, w)) in enumerate(zip(scores, groups)):
        if s.dtype != torch.float32 or not s.is_contiguous():
            raise ValueError(f"per_level_topk: octave {o} must be contiguous float32, got {s.dtype}"
                             f"{'' if s.is_contiguous() else ' (not contiguous)'}")
        if tuple(s.shape) != (n, B, h, w):
            raise ValueError(f"per_level_topk: octave {o} must be (n, B, h, w) = {(n, B, h, w)}, "
                             f"got {tuple(s.shape)}")
        if s.device != dev:
            raise ValueError(f"per_level_topk: octave {o} is on {s.device}, octave 0 on {dev}")


def per_level_topk(scores, statics) -> dict:
    """(B, L, K) candidates of per-octave (n, B, h, w) score stacks: the
    kernel on CUDA tensors, the plain form on CPU tensors."""
    global _latest_paths
    groups = statics.groups
    _check(scores, groups)
    if statics.h0 * statics.w0 >= 2**31:
        raise ValueError(f"per_level_topk: the octave-0 index overflows int32: {statics.h0} x {statics.w0} px")
    dev = scores[0].device
    if dev.type == "cpu":
        return per_level_topk_plain(scores, statics)
    _build.require_cuda(scores[0], "per_level_topk")
    if len(groups) > MAX_OCTAVES:
        raise ValueError(f"per_level_topk: at most {MAX_OCTAVES} octaves, got {len(groups)}")
    K = statics.config.per_level_candidates
    cap = capacity(K)
    if cap > 16384:
        raise ValueError(f"per_level_topk: per_level_candidates {K} exceeds the kernel's 16,384")
    B, L = scores[0].shape[1], statics.num_levels
    out = {name: torch.empty((B, L, K), dtype=dtype, device=dev) for name, dtype in (
        ("resp", torch.float32), ("yi", torch.int32), ("xi", torch.int32), ("flat", torch.int32),
        ("valid", torch.bool))}
    if B * L * K == 0:
        return out
    scratch = torch.empty((B * L, cap), dtype=torch.int64, device=dev)
    ws = torch.empty(3 + 3 * B * L, dtype=torch.int32, device=dev)
    noct = len(groups)
    ptrs = (ctypes.c_void_p * noct)(*(s.data_ptr() for s in scores))
    ns, hs, widths = ((ctypes.c_int * noct)(*(g[i] for g in groups)) for i in (1, 2, 3))
    P_, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("topk", "per_level_topk",
                         [P_, P_, P_, P_, I, I, I, I, ctypes.c_float, P_, I, P_, P_, P_, P_, P_, P_, P_])
    with torch.cuda.device(dev):
        err = fn(ptrs, ns, hs, widths, noct, B, K, statics.w0, NEG, scratch.data_ptr(), cap, ws.data_ptr(),
                 out["resp"].data_ptr(), out["yi"].data_ptr(), out["xi"].data_ptr(), out["flat"].data_ptr(),
                 out["valid"].data_ptr(), _build.stream_of(scores[0]))
    _build.check("topk", err, "per_level_topk")
    _build.launches["topk"] += 1
    _latest_paths = ws[:3]
    return out


def path_counts() -> dict | None:
    """{"fast", "cut", "general"}: planes by path in the latest kernel call
    (None before the first); waits for the card."""
    if _latest_paths is None:
        return None
    return dict(zip(PATHS, _latest_paths.tolist()))
