"""Rank meshes and exact collectives of the port's parallel paths.

A `Mesh` lays the ranks of the process group out on named axes, such as
`("data",)` or `("stage", "data")`, with one process group per line of
ranks along each axis.  In a process with no process group it is a mesh of
one rank, and every collective returns its input.

Every collective here is one all-reduce (sum) over an axis, the one
operation that both NCCL and gloo take on CUDA tensors:
  * `all_gather` and `exchange` (halo rows, stage hand-offs; the JAX
    package's `all_gather` and `ppermute`) fill a zero buffer in which each
    rank writes only its own part, and sum it as int32 words, so every bit
    pattern arrives as it was sent (a float sum would turn -0.0 into +0.0);
  * `all_sum` (the JAX package's `psum`) gathers every rank's part and adds
    the parts in rank order on each rank, so every rank gets the same bits,
    run after run, whatever order the backend sums in.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from akaze_tpu_torch.parallel.distributed import rank_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a mesh of ranks.

    shape / axis_names: the mesh; device: this rank's device; coords: this
    rank's index along each axis; groups: per axis the process group of the
    ranks that differ from this one only along that axis (None where the
    axis has one rank)."""

    shape: tuple
    axis_names: tuple
    device: torch.device
    coords: tuple
    groups: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes are {self.axis_names}, not {axis!r}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self._axis(axis)]

    def group(self, axis: str):
        return self.groups[self._axis(axis)]

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (row-major over the axes)."""
        return int(np.ravel_multi_index(self.coords, self.shape))


def build_mesh(shape, axis_names, device="cuda") -> Mesh:
    """A mesh of the given shape over every rank of the process group (row
    major: the last axis varies fastest), or over the one process where
    none runs.  Every rank must call it, with the same arguments."""
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world or len(shape) != len(axis_names):
        raise ValueError(f"a mesh {dict(zip(axis_names, shape))} needs {math.prod(shape)} ranks; the world has "
                         f"{world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    ids = np.arange(world).reshape(shape)
    groups = []
    for a, n in enumerate(shape):
        mine = None
        if n == world > 1:
            mine = dist.group.WORLD
        elif n > 1:
            # Every rank creates every group, in the same order.
            for line in np.moveaxis(ids, a, -1).reshape(-1, n):
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    mine = g
        groups.append(mine)
    return Mesh(shape, axis_names, rank_device(device), coords, tuple(groups))


def _pack(tensors) -> torch.Tensor:
    """The bytes of `tensors` as one int32 vector, each padded to 4 bytes."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 4
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        parts.append(b)
    return torch.cat(parts).view(torch.int32)


def _unpack(words: torch.Tensor, like) -> list:
    """Tensors shaped and typed as `like` from `_pack`'s words."""
    b = words.contiguous().view(torch.uint8)
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(b[at : at + n].clone().view(t.dtype).reshape(t.shape))
        at += n + (-n % 4)
    return out


def _sum_words(buf: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(buf, group=group)
    return buf


def gather_parts(tensors, mesh: Mesh, axis: str = "data") -> list:
    """Every rank's `tensors` (the same shapes and dtypes on every rank of
    the axis), bit for bit: a list over the axis' ranks, in order."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    tensors = list(tensors)
    if n == 1:
        return [tensors]
    words = _pack(tensors)
    buf = words.new_zeros((n, words.numel()))
    buf[i] = words
    buf = _sum_words(buf, mesh.group(axis))
    return [_unpack(buf[j], tensors) for j in range(n)]


def all_gather(tensors, mesh: Mesh, axis: str = "data") -> list:
    """Each of `tensors` concatenated along dim 0 over the axis' ranks, in
    rank order, bit for bit."""
    parts = gather_parts(tensors, mesh, axis)
    return [torch.cat([p[k] for p in parts]) for k in range(len(parts[0]))]


def all_sum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The sum of `x` over the axis' ranks, added in rank order on every
    rank, so every rank holds the same bits."""
    parts = gather_parts([x], mesh, axis)
    acc = parts[0][0]
    for p in parts[1:]:
        acc = acc + p[0]
    return acc


def exchange(sends, like, mesh: Mesh, axis: str = "data", slots: int = 1) -> list:
    """Point-to-point sends along an axis in one all-reduce (the JAX
    package's `lax.ppermute`): `sends` lists (destination index, slot,
    tensors shaped as `like`) for this rank, and at most one rank sends to
    each (destination, slot).  Every rank of the axis calls it with the
    same `like` and `slots`.  Returns what this rank received, one list of
    tensors per slot; zeros where nothing was sent to it."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    template = _pack(like)
    buf = template.new_zeros((n, slots, template.numel()))
    for dst, slot, tensors in sends:
        buf[dst, slot] = _pack(tensors)
    buf = _sum_words(buf, mesh.group(axis))
    return [_unpack(buf[i, s], like) for s in range(slots)]


def rank_rows(n_rows: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous block of `n_rows` rows (n_rows must be a
    multiple of the axis size)."""
    n = mesh.axis_size(axis)
    if n_rows % n:
        raise ValueError(f"{n_rows} rows are not divisible by the mesh axis {axis!r} of {n} ranks")
    per = n_rows // n
    return slice(mesh.axis_index(axis) * per, (mesh.axis_index(axis) + 1) * per)
