"""The `data` mesh and the data-parallel batch extract of the port
(counterpart of the JAX package's `akaze_tpu/parallel/mesh.py`).

    mesh = make_mesh()  # the `data` axis over every rank
    feats = gather_features(extract_batch_sharded(frames, mesh), mesh)

`extract_batch_sharded` runs each rank's contiguous slice of the batch
through `extract_batch_fn` (kernels 1-3) on the mesh's device.  Each frame
is computed as the unsharded batch computes it, so the gathered features
equal `extract_batch`'s bit for bit.  The collectives are those of
`parallel/collectives.py`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.types import Features, Keypoints
from akaze_tpu_torch.frontend.pipeline import _as_tensor, extract_batch_fn
from akaze_tpu_torch.parallel.collectives import Mesh, all_gather, all_sum, build_mesh, rank_rows


def make_mesh(num_data: int | None = None, device="cuda") -> Mesh:
    """1-D `data` mesh over every rank.  `num_data`, where given, must equal
    the number of ranks (the JAX package's `make_mesh(n)` takes n devices;
    here a rank drives one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is not None and num_data != world:
        raise ValueError(f"make_mesh({num_data}): the world has {world} ranks; start {num_data} processes "
                         f"(python -m torch.distributed.run --nproc-per-node {num_data} ...)")
    return build_mesh((world,), ("data",), device)


def extract_batch_sharded(imgs, mesh: Mesh, config: AkazeConfig | None = None) -> Features:
    """Batched extraction with the frame axis sharded over `data`: this
    rank's contiguous B / n frames of `imgs` ((B, H, W), tensor or numpy,
    the same on every rank) through `extract_batch_fn` on the mesh's
    device.  B must be a multiple of the mesh size.  Returns this rank's
    Features ((B / n, M) leaves); `gather_features` collects the batch."""
    config = config or AkazeConfig()
    if imgs.ndim != 3:
        raise ValueError(f"extract_batch_sharded expects (B, H, W) frames, got shape {tuple(imgs.shape)}")
    rows = rank_rows(imgs.shape[0], mesh)
    return extract_batch_fn(_as_tensor(imgs[rows], mesh.device), config)


def gather_features(feats: Features, mesh: Mesh, axis: str = "data") -> Features:
    """The whole batch of every rank's Features on every rank, in rank
    order, bit for bit."""
    names = [f.name for f in dataclasses.fields(Keypoints)]
    out = all_gather([getattr(feats.keypoints, k) for k in names] + [feats.descriptors], mesh, axis)
    return Features(keypoints=Keypoints(**dict(zip(names, out[:-1]))), descriptors=out[-1])


def total_valid_keypoints(feats: Features, mesh: Mesh, axis: str = "data") -> int:
    """The valid keypoints of the whole sharded batch (an all-reduce)."""
    return int(all_sum(feats.keypoints.valid.sum().to(torch.int64).reshape(1), mesh, axis)[0])
