"""Kernel 7 (`gather_patches`): per-keypoint (3, ph, pw) crops of the Lt /
Lx / Ly level stacks, with its plain PyTorch twin (counterpart of the JAX
package's `akaze_tpu/kernels/patch_pallas.py`).

    out[n, c] = stack_c[frame[n], lvl[n], y0[n] : y0[n] + ph, x0[n] : x0[n] + pw]

for valid slots, zeros for invalid ones.  The stacks are frame-major
(F, L, H0, W0), level-major (L, F, H0, W0) when stacks["level_major"] is
set, or one frame's (L, H0, W0), as in the JAX kernel; any strides work as
long as each plane's rows are contiguous.  Start indices clamp as
`lax.dynamic_slice` clamps them.  Any slot count N is taken (the JAX
kernel's N % 8 and aligned superset fetch are Mosaic constraints).
"""

from __future__ import annotations

import ctypes

import torch

from akaze_tpu_torch.kernels import _build

_CHANNELS = ("Lt", "Lx", "Ly")


def frame_major_views(stacks: dict) -> list[torch.Tensor]:
    """Lt, Lx, Ly as (F, L, H0, W0) views of whichever layout they come in."""
    planes = [stacks[k] for k in _CHANNELS]
    if planes[0].ndim == 3:
        return [p[None] for p in planes]
    if stacks.get("level_major", False):
        return [p.transpose(0, 1) for p in planes]
    return planes


def _clamped_indices(views, frame, lvl, y0, x0, ph: int, pw: int):
    F, L, H0, W0 = views[0].shape
    if ph > H0 or pw > W0:
        raise ValueError(f"gather_patches: a ({ph}, {pw}) patch does not fit ({H0}, {W0}) planes")
    return (torch.clamp(frame.long(), 0, F - 1), torch.clamp(lvl.long(), 0, L - 1),
            torch.clamp(y0.long(), 0, H0 - ph), torch.clamp(x0.long(), 0, W0 - pw))


def gather_patches_plain(stacks: dict, frame, lvl, y0, x0, valid, ph: int, pw: int) -> torch.Tensor:
    """(N, 3, ph, pw) patches by advanced indexing, in plain PyTorch."""
    views = frame_major_views(stacks)
    f, l, y, x = _clamped_indices(views, frame, lvl, y0, x0, ph, pw)
    dev = views[0].device
    rows = (y[:, None] + torch.arange(ph, device=dev))[:, :, None]
    cols = (x[:, None] + torch.arange(pw, device=dev))[:, None, :]
    out = torch.stack([v[f[:, None, None], l[:, None, None], rows, cols] for v in views], dim=1)
    return torch.where(valid.bool()[:, None, None, None], out, torch.zeros((), device=dev))


def gather_patches(stacks: dict, frame, lvl, y0, x0, valid, ph: int, pw: int) -> torch.Tensor:
    """Kernel 7 on CUDA stacks (one block per slot and channel), its plain
    twin on CPU stacks.  frame/lvl/y0/x0/valid: (N,) integer or bool."""
    views = frame_major_views(stacks)
    if views[0].device.type == "cpu":
        return gather_patches_plain(stacks, frame, lvl, y0, x0, valid, ph, pw)
    _build.require_cuda(views[0], "gather_patches")
    dev = views[0].device
    F, L, H0, W0 = views[0].shape
    for v in views:
        if (v.dtype != torch.float32 or v.device != dev or v.shape != views[0].shape
                or v.stride() != views[0].stride() or v.stride(3) != 1 or v.stride(2) != W0):
            raise ValueError("gather_patches: Lt/Lx/Ly must be float32 stacks of one shape on one "
                             "device, with the same strides and contiguous rows")
    if ph > H0 or pw > W0:
        raise ValueError(f"gather_patches: a ({ph}, {pw}) patch does not fit ({H0}, {W0}) planes")
    idx = [t.to(device=dev, dtype=torch.int32).contiguous() for t in (frame, lvl, y0, x0, valid)]
    n = idx[0].shape[0]
    out = torch.empty((n, 3, ph, pw), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("patch", "gather_patches", [
        P, P, P, P, P, P, P, P, P, I, I, I, ctypes.c_longlong, ctypes.c_longlong, I, I, I, I, P,
    ])
    with torch.cuda.device(dev):
        err = fn(*(v.data_ptr() for v in views), *(t.data_ptr() for t in idx), out.data_ptr(), n,
                 F, L, views[0].stride(0), views[0].stride(1), H0, W0, ph, pw, _build.stream_of(out))
    _build.check("patch", err, "gather_patches")
    _build.launches["gather_patches"] += 1
    return out
