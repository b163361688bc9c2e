"""Spatial (intra-image) sharding of the port: FED diffusion with a 1-row
halo exchange (counterpart of the JAX package's
`akaze_tpu/parallel/spatial.py`).

The rows of one plane are split over a mesh axis.  Before each tau step a
rank swaps its edge rows with its neighbours (`collectives.exchange`, one
all-reduce of int32 words, so the rows arrive bit for bit); at the plane's
top and bottom a rank replicates its own edge row, as the unsharded stencil
does.  `diffusion_step` (the plain PyTorch step, as the JAX package runs
its plain step here) then runs on the block with its halo, and rows 1..-1
of its output see their true neighbours: the result equals `fed_cycle` on
the whole plane bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from akaze_tpu_torch.frontend.pipeline import _as_tensor
from akaze_tpu_torch.frontend.scale_space import diffusion_step
from akaze_tpu_torch.parallel.collectives import Mesh, exchange, rank_rows


def _exchange_halos(blocks, mesh: Mesh, axis: str) -> list:
    """[(top, bottom) halo rows] of each (h, W) block in `blocks`: the
    previous rank's last row and the next rank's first row, or the block's
    own edge row at the plane's edge.  One all-reduce for all blocks."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    firsts = [b[:1] for b in blocks]
    lasts = [b[-1:] for b in blocks]
    # Slot 0 of rank j: its top halo (from rank j - 1); slot 1: its bottom.
    sends = ([(i + 1, 0, lasts)] if i + 1 < n else []) + ([(i - 1, 1, firsts)] if i > 0 else [])
    from_above, from_below = exchange(sends, firsts, mesh, axis, slots=2)
    top = firsts if i == 0 else from_above
    bottom = lasts if i == n - 1 else from_below
    return list(zip(top, bottom))


def sharded_fed_cycle(lt, g, taus: Sequence[float], mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """One level's FED tau steps with the rows sharded over `axis`.

    lt, g: the whole (H, W) plane (tensor or numpy, the same on every rank),
    H a multiple of the axis size.  Returns this rank's (H / n, W) block of
    the result on the mesh's device; `collectives.all_gather` collects the plane."""
    rows = rank_rows(lt.shape[0], mesh, axis)
    lt = _as_tensor(lt[rows], mesh.device).to(torch.float32)
    g = _as_tensor(g[rows], mesh.device).to(torch.float32)
    if len(taus) == 0:
        return lt
    # g does not change over the steps: its halo rows are swapped once.
    (g_top, g_bottom), = _exchange_halos([g], mesh, axis)
    g_ext = torch.cat([g_top, g, g_bottom])
    for tau in taus:
        (top, bottom), = _exchange_halos([lt], mesh, axis)
        lt = diffusion_step(torch.cat([top, lt, bottom]), g_ext, tau)[1:-1]
    return lt
