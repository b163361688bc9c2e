"""The scene `textured_pan`: a pan of crops across one textured scene.

`textured_scene` and `sequence` follow the port's NumPy scenes
(`akaze_tpu_torch/utils/synthetic.py` `textured_scene` / `video_sequence`):
smooth gradients, Gaussian blobs, a warped two-scale checkerboard and
band-limited noise on a base image twice the frame size, and a pan of
crops across it that stands in for the camera's motion.  Their pixels are
not NumPy's: the random numbers come from the torch.Generator the
generator hands over.  The mix's "pan" group gives the pan's amplitudes.
"""

from __future__ import annotations

import math

import torch


def textured_scene(height: int, width: int, gen: torch.Generator, device) -> torch.Tensor:
    """float32 (H, W) in [0, 1] with multi-scale structure."""
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    img = 0.3 + 0.2 * torch.sin(2 * math.pi * x / width) * torch.cos(2 * math.pi * y / height)
    n_blobs = max(20, width * height // 4000)
    u = torch.rand((n_blobs, 4), generator=gen, device=device)
    cx = (0.05 + 0.9 * u[:, 0]) * width
    cy = (0.05 + 0.9 * u[:, 1]) * height
    s = 1.5 + 18.5 * u[:, 2]
    a = u[:, 3] - 0.5
    for b0 in range(0, n_blobs, 16):
        sl = slice(b0, b0 + 16)
        d2 = (x[None] - cx[sl, None, None]) ** 2 + (y[None] - cy[sl, None, None]) ** 2
        img = img + (a[sl, None, None] * torch.exp(-d2 / (2 * s[sl, None, None] ** 2))).sum(0)
    uu = x / width * 16 + 0.7 * torch.sin(2 * math.pi * y / height * 2)
    vv = y / height * 12 + 0.7 * torch.sin(2 * math.pi * x / width * 3)
    img = img + 0.25 * (torch.remainder(torch.floor(uu) + torch.floor(vv), 2) - 0.5)
    img = img + 0.12 * (torch.remainder(torch.floor(uu * 3.7) + torch.floor(vv * 3.1), 2) - 0.5)
    coarse = torch.randn((height // 8 + 1, width // 8 + 1), generator=gen, device=device)
    noise = coarse.repeat_interleave(8, 0).repeat_interleave(8, 1)[:height, :width]
    img = img + 0.03 * noise
    img = img - img.min()
    return img / img.max()


def sequence(mix: dict, frames: int, height: int, width: int, gen: torch.Generator, device) -> torch.Tensor:
    """uint8 (T, H, W): crops of one scene twice the frame size, panning
    `mix["pan"]["x_px"]` and `["y_px"]` about its centre once over the T
    frames."""
    pan = mix["pan"]
    base = textured_scene(2 * height, 2 * width, gen, device)
    out = torch.empty((frames, height, width), dtype=torch.uint8, device=device)
    for t in range(frames):
        ox = int(width / 2 + pan["x_px"] * math.sin(2 * math.pi * t / max(frames, 2)))
        oy = int(height / 2 + pan["y_px"] * math.cos(2 * math.pi * t / max(frames, 2)))
        out[t] = torch.round(base[oy : oy + height, ox : ox + width] * 255.0).to(torch.uint8)
    return out
