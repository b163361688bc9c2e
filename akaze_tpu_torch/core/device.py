"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The torch device for `device`; a CUDA device without a GPU raises
    (the entry points never carry on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("akaze_tpu_torch runs on CUDA by default and no GPU is available; "
                           "pass device='cpu' to run the plain PyTorch twins")
    return device
