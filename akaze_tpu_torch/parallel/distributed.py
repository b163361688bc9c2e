"""Multi-process bootstrap of the port's parallel paths (counterpart of the
JAX package's `akaze_tpu/parallel/distributed.py`).

One process per rank.  `initialize` starts `torch.distributed` from
explicit arguments or from the variables `torch.distributed.run` sets
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK); without either it
is a no-op and the process is a world of one, as the JAX package's is on a
single host.  `global_mesh` is the `data` mesh over every rank, and
`shutdown` ends the process group, so that a respawned survivor can
initialize again with a smaller world.

The backend is NCCL where every rank of the host has a card of its own and
gloo where ranks share a card (NCCL refuses two ranks on one GPU) or run on
the CPU.  The collectives of `parallel/mesh.py` are all all-reduces, which
gloo takes on CUDA tensors too, so the tensors and the compute stay on the
card whichever backend carries them.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from akaze_tpu_torch.core.device import resolve_device

logger = logging.getLogger("akaze_tpu_torch")


def rank_device(device="cuda") -> torch.device:
    """This rank's device: for "cuda", card LOCAL_RANK (or the global rank)
    modulo the cards present, so ranks beyond the card count share them."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device, local_world_size: int) -> str:
    """"nccl" where each of the host's ranks has a card of its own, else
    "gloo"."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def initialize(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
               device="cuda", timeout_s: float = 300.0) -> bool:
    """Start the process group once per process; returns whether one runs.

    With `init_method` (e.g. "tcp://127.0.0.1:29500") the caller gives
    `world_size` and `rank`; without it the variables of
    `torch.distributed.run` are read; with neither this is a no-op (a world
    of one).  A collective that waits longer than `timeout_s` for a peer
    raises, so a lost rank fails its survivors instead of hanging them."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            logger.debug("single process: no process group")
            return False
        init_method = "env://"
        world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    if world_size is None or rank is None:
        raise ValueError("initialize(init_method=...) needs world_size and rank")
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    backend = choose_backend(resolve_device(device), local_world)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("distributed initialized: rank %d of %d, backend %s", rank, world_size, backend)
    return True


def backend() -> str | None:
    """The process group's backend, None in a world of one."""
    return dist.get_backend() if dist.is_initialized() else None


def global_mesh(data: int | None = None, device="cuda"):
    """The `data` mesh over every rank (call `initialize` first)."""
    from akaze_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data, device=device)


def shutdown() -> None:
    """End the process group (a no-op in a world of one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
