"""Stage pipelining of the port: the 3-stage extract | match | pose
pipeline over a (stage, data) mesh of ranks (counterpart of the JAX
package's `akaze_tpu/parallel/pipeline_stage.py`).

    stage 0  extract   each data lane extracts its slice of the microbatch
                       (kernels 1-3)
    stage 1  match     the lanes all-gather the microbatch's features over
                       `data`, then each matches its slice of consecutive
                       pairs (kernel 4), the previous microbatch's last
                       frame included
    stage 2  pose      each lane runs the batched RANSAC essential + pose on
                       its slice of matched pairs

Every rank runs the same loop of T + 2 steps for T microbatches (the
pipeline's bubble): at step i stage 0 extracts microbatch i, stage 1
matches microbatch i - 1 and stage 2 poses microbatch i - 2; at the end of
a step each lane hands its activations on along `stage` in one exchange
(the JAX package's `ppermute`), and the per-frame counts are summed over
every rank at the end.  The outputs and their row alignment are the JAX
package's, and they equal `sequential_stream`, the unpipelined path on one
rank: each frame's features, matches and RANSAC draws do not depend on the
mesh.

RANSAC draws: the pair ending at frame f draws its scores from `draws(f,
(H, N))` where given (`interop.jax_uniform(seed, shape, fold_in=f)` gives
the JAX package's `fold_in(PRNGKey(seed), f)` draws), else from a
`torch.Generator` seeded with (rconfig.seed, f).

With one card the ranks share it and take turns on it: the pipeline shows
that the stages compute the unpipelined result across processes, not that
they overlap in time.
"""

from __future__ import annotations

import numpy as np
import torch

from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, RansacConfig
from akaze_tpu_torch.core.device import resolve_device
from akaze_tpu_torch.frontend.pipeline import _as_tensor, extract_batch_fn
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose_fn, normalize_points
from akaze_tpu_torch.matching.hamming import match_fn
from akaze_tpu_torch.parallel.collectives import Mesh, all_gather, all_sum, build_mesh, exchange

NUM_STAGES = 3  # extract | match | pose


def make_stage_mesh(data: int = 1, device="cuda") -> Mesh:
    """(stage, data) mesh: NUM_STAGES stage rows of `data` lanes; the world
    must hold NUM_STAGES x data ranks."""
    return build_mesh((NUM_STAGES, data), ("stage", "data"), device)


def _defaults(frames, config, mconfig, rconfig, intr):
    config = config or AkazeConfig()
    mconfig = mconfig or MatchConfig(max_distance=120)
    rconfig = rconfig or RansacConfig(num_iterations=64)
    if frames.ndim != 3:
        raise ValueError(f"expected (T, H, W) frames, got shape {tuple(frames.shape)}")
    t, h, w = frames.shape
    intr = intr or (float(w), float(w), w / 2.0, h / 2.0)
    return config, mconfig, rconfig, tuple(intr)


def frame_scores(frame_ids, rconfig: RansacConfig, n: int, device: torch.device, draws=None) -> torch.Tensor:
    """(len(frame_ids), H, n) RANSAC scores, one (H, n) draw per frame."""
    shape = (rconfig.num_iterations, n)
    if draws is not None:
        return torch.from_numpy(np.stack([np.asarray(draws(int(f), shape), np.float32) for f in frame_ids])
                                ).to(device)
    out = []
    for f in frame_ids:
        g = torch.Generator(device=device)
        g.manual_seed((rconfig.seed << 32) + int(f))
        out.append(torch.rand(shape, generator=g, device=device))
    return torch.stack(out)


def _match_pairs(prev, cur, mconfig, intr):
    """Match frames `prev` against `cur` pairwise ((P, M) leaves each:
    descriptors, valid, x, y); returns (match counts, normalized
    correspondences (x1, x2, accepted))."""
    m = match_fn(prev[0], prev[1], cur[0], cur[1], mconfig)
    x1 = normalize_points(prev[2], prev[3], intr)
    idx = m.idx_b.long()
    x2 = normalize_points(torch.gather(cur[2], 1, idx), torch.gather(cur[3], 1, idx), intr)
    return m.count(), (x1, x2, m.accepted)


def _pose_inliers(corr, rconfig, frame_ids, draws) -> torch.Tensor:
    x1, x2, acc = corr
    scores = frame_scores(frame_ids, rconfig, acc.shape[-1], acc.device, draws)
    return estimate_relative_pose_fn(x1, x2, acc, rconfig, sample_scores=scores).num_inliers


def _fields(feats) -> list:
    kp = feats.keypoints
    return [feats.descriptors, kp.valid, kp.x, kp.y]


def sequential_stream(frames, config: AkazeConfig | None = None, mconfig: MatchConfig | None = None,
                      rconfig: RansacConfig | None = None, intr: tuple | None = None, draws=None,
                      device="cuda") -> dict:
    """The unpipelined path on one rank (the reference of
    `pipelined_stream`): extract every frame, match each frame against its
    predecessor, pose each pair on the same per-frame draws."""
    config, mconfig, rconfig, intr = _defaults(frames, config, mconfig, rconfig, intr)
    dev = resolve_device(device)
    f = _fields(extract_batch_fn(_as_tensor(frames, dev), config))
    t = frames.shape[0]
    counts, corr = _match_pairs([x[:-1] for x in f], [x[1:] for x in f], mconfig, intr)
    inliers = _pose_inliers(corr, rconfig, range(1, t), draws)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return {"match_counts": torch.cat([zero, counts]).cpu().numpy(),
            "pose_inliers": torch.cat([zero, inliers]).cpu().numpy()}


def pipelined_stream(frames, mesh: Mesh, config: AkazeConfig | None = None, mconfig: MatchConfig | None = None,
                     rconfig: RansacConfig | None = None, microbatch: int = 2, intr: tuple | None = None,
                     draws=None) -> dict:
    """Run the 3-stage pipeline over a (T, H, W) sequence (tensor or numpy,
    the same on every rank) on a (stage, data) mesh; every rank of the mesh
    calls it.  Returns, on every rank, per-frame consecutive-match counts and
    pose inlier counts ((T,) numpy each; frame 0 has no predecessor, so its
    entries are 0).  `microbatch` must be a multiple of the data lanes."""
    config, mconfig, rconfig, intr = _defaults(frames, config, mconfig, rconfig, intr)
    D = mesh.axis_size("data")
    if microbatch % D:
        raise ValueError(f"microbatch {microbatch} is not a multiple of the {D} data lanes")
    B, local_b = microbatch, microbatch // D
    stage, lane = mesh.axis_index("stage"), mesh.axis_index("data")
    dev = mesh.device
    t = frames.shape[0]
    num_mb = -(-t // B)
    # Pad to whole microbatches with copies of the last frame.
    pad_idx = np.minimum(np.arange(num_mb * B), t - 1)
    cap, words = config.max_keypoints, config.descriptor_words

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    feats_like = [zeros(local_b, cap, words, dtype=torch.int32), zeros(local_b, cap, dtype=torch.bool),
                  zeros(local_b, cap), zeros(local_b, cap)]
    corr_like = [zeros(local_b, cap, 3), zeros(local_b, cap, 3), zeros(local_b, cap, dtype=torch.bool)]
    counts = zeros(num_mb, B, dtype=torch.int32)
    inliers = zeros(num_mb, B, dtype=torch.int32)
    feats_recv, corr_recv = feats_like, corr_like
    prev_last = [x[0] for x in feats_like]  # microbatch 0's first frame has no predecessor
    s0 = lane * local_b
    for step in range(num_mb + NUM_STAGES - 1):
        feats_out, corr_out = feats_like, corr_like
        if stage == 0 and step < num_mb:
            sl = pad_idx[step * B + s0 : step * B + s0 + local_b]
            feats_out = _fields(extract_batch_fn(_as_tensor(frames[sl], dev), config))
        elif stage == 1 and 1 <= step <= num_mb:
            full = all_gather(feats_recv, mesh, "data")  # (B, cap, ...) leaves, lanes in order
            prev = [torch.cat([p[None], x[:-1]]) for p, x in zip(prev_last, full)]
            mine = slice(s0, s0 + local_b)
            c, corr = _match_pairs([x[mine] for x in prev], [x[mine] for x in full], mconfig, intr)
            counts[step - 1, mine] = c
            corr_out = list(corr)
            prev_last = [x[-1] for x in full]
        elif stage == 2 and 2 <= step <= num_mb + 1:
            m = step - 2
            ids = range(m * B + s0, m * B + s0 + local_b)  # the second frame of each pair
            inliers[m, s0 : s0 + local_b] = _pose_inliers(corr_recv, rconfig, ids, draws)
        # Hand the activations on: stage 0 -> 1 (features), 1 -> 2 (correspondences).
        sends = {0: [(1, 0, feats_out + corr_like)], 1: [(2, 0, feats_like + corr_out)]}.get(stage, [])
        got = exchange(sends, feats_like + corr_like, mesh, "stage")[0]
        feats_recv, corr_recv = got[: len(feats_like)], got[len(feats_like) :]
    tables = torch.stack([counts, inliers])
    for axis in ("data", "stage"):
        tables = all_sum(tables, mesh, axis)
    out = tables.reshape(2, -1)[:, :t].cpu().numpy().copy()
    out[:, 0] = 0
    return {"match_counts": out[0], "pose_inliers": out[1]}


def pipelined_match_counts(frames, mesh: Mesh, config: AkazeConfig | None = None,
                           mconfig: MatchConfig | None = None, microbatch: int = 2) -> np.ndarray:
    """Consecutive-frame match counts through the pipeline."""
    return pipelined_stream(frames, mesh, config, mconfig, microbatch=microbatch)["match_counts"]
