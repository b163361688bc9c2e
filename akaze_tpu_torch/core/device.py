"""Device choice of the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The torch device for `device`; a CUDA device without a GPU raises
    (the entry points never carry on quietly on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("akaze_tpu_torch runs on CUDA by default and no GPU is available; "
                           "pass device='cpu' to run the plain PyTorch twins")
    return device


def upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on `device`; to CUDA from pinned memory,
    without a host sync (a blocking upload from pageable memory waits for
    the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
