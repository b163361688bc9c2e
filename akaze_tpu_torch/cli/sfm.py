"""`python -m akaze_tpu_torch.cli.sfm`: incremental SfM over a frame
sequence (front-end tracks -> loop closures -> two-view init -> PnP ->
triangulation -> BA), on the card unless --device cpu; writes the
trajectory, the sparse map's size and optionally a resumable checkpoint.

With `--mesh N` the bundle adjustments shard their points over N ranks:

    python -m torch.distributed.run --nproc-per-node N -m akaze_tpu_torch.cli.sfm frames.npy -o traj.json --mesh N

Rank 0 runs the front end and sends the tracks and loop closures to the
other ranks, every rank runs the same SfM schedule, and only rank 0 writes
files."""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def main(argv=None) -> int:
    from akaze_tpu_torch.cli.extract import add_config_args

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames", help="(T,H,W) .npy/.npz or a directory of images")
    p.add_argument("-o", "--output", required=True, help="output .json trajectory")
    add_config_args(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--intrinsics", type=float, nargs=4, metavar=("FX", "FY", "CX", "CY"),
                   help="camera intrinsics (default fx=fy=W, c=center)")
    p.add_argument("--checkpoint", help="write the SfM map checkpoint here (.npz)")
    p.add_argument("--ba-iterations", type=int, default=10)
    p.add_argument("--mesh", type=int, default=0,
                   help="shard BA points over this many ranks, started by torch.distributed.run (0 = one process)")
    p.add_argument("--no-loop-closure", action="store_true",
                   help="disable keyframe loop-closure detection + pose-graph optimization")
    p.add_argument("--loop-min-gap", type=int, default=8, help="minimum keyframe separation for closure candidates")
    p.add_argument("--loop-min-matches", type=int, default=60,
                   help="descriptor matches required to verify a candidate")
    p.add_argument("--loop-min-inliers", type=int, default=30, help="RANSAC inliers required to accept a closure")
    args = p.parse_args(argv)

    from akaze_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if not args.mesh:
        return _run(args, device, None)

    import torch.distributed as dist

    from akaze_tpu_torch.parallel import distributed
    from akaze_tpu_torch.parallel.mesh import make_mesh

    distributed.initialize(device=device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != args.mesh:
            p.error(f"--mesh {args.mesh} shards over {args.mesh} ranks and this run has {world}: start it with "
                    f"python -m torch.distributed.run --nproc-per-node {args.mesh} -m akaze_tpu_torch.cli.sfm "
                    f"... --mesh {args.mesh}")
        mesh = make_mesh(args.mesh, device=device)
        return _run(args, mesh.device, mesh)
    finally:
        distributed.shutdown()


def _run(args, device, mesh) -> int:
    import torch

    from akaze_tpu_torch.cli.extract import build_config
    from akaze_tpu_torch.cli.sequence import load_frames
    from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
    from akaze_tpu_torch.sfm.checkpoint import SfmCheckpoint, save_checkpoint
    from akaze_tpu_torch.sfm.incremental import run_incremental
    from akaze_tpu_torch.sfm.metrics import camera_centers
    from akaze_tpu_torch.utils.profiling import MetricsLogger, SpanRecorder, record_spans, span

    rec = SpanRecorder()
    with record_spans(rec):
        front = None
        if mesh is None or mesh.rank == 0:
            front = _front_end(args, load_frames(args.frames), build_config(args), device)
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist

            from akaze_tpu_torch.parallel.distributed import backend

            box = [front]
            dist.broadcast_object_list(box, src=0, device=device if backend() == "nccl" else
                                       torch.device("cpu"))
            front = box[0]
        num_frames, num_tracks, observations, closures = front
        with span("sfm", device):
            sfm = run_incremental(observations, num_frames, SfmConfig(ba_iterations=args.ba_iterations),
                                  RansacConfig(), closures=closures, device=device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the one sync: the stages' events are read
    stage_seconds = {s.name: rec.seconds(s.name) for s in rec.spans if s.parent is None}

    centers = camera_centers(sfm.poses)
    out = {
        "num_frames": num_frames,
        "num_tracks": num_tracks,
        "num_points": int(len(sfm.points)),
        "num_loop_closures": len(closures),
        "poses": sfm.poses.tolist(),
        "camera_centers": centers.tolist(),
    }
    pathlib.Path(args.output).write_text(json.dumps(out, indent=1))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, SfmCheckpoint(
            poses=sfm.poses, points=np.asarray(sfm.points), track_point=sfm.track_point,
            keyframe_frames=sfm.keyframe_frames, next_keyframe=num_frames,
        ))
    MetricsLogger().log("sfm_done", frames=num_frames, tracks=num_tracks, points=int(len(sfm.points)),
                        loop_closures=len(closures), stage_seconds=stage_seconds)
    print(f"{num_frames} frames, {num_tracks} tracks, {len(sfm.points)} points -> {args.output}")
    return 0


def _front_end(args, frames, config, device):
    """Video front end, tracks and loop closures: (number of frames, number
    of tracks, per-track normalized observations, closures); each stage in
    a span of its name."""
    from akaze_tpu_torch.matching.video import process_video
    from akaze_tpu_torch.sfm.incremental import build_tracks
    from akaze_tpu_torch.utils.profiling import span

    h, w = frames.shape[1:]
    fx, fy, cx, cy = args.intrinsics if args.intrinsics else (float(w), float(w), w / 2.0, h / 2.0)
    with span("process_video", device):
        res = process_video(frames, config, batch=args.batch, device=device)

    with span("tracks", device):
        acc = res.matches_prev.accepted.cpu().numpy()
        idx = res.matches_prev.idx_b.cpu().numpy()
        matches = [np.stack([np.nonzero(acc[t + 1])[0], idx[t + 1][acc[t + 1]]], axis=1)
                   for t in range(len(frames) - 1)]
        tracks = build_tracks(matches, len(frames))

    # Loop closure: match the keyframe database pairwise, verify with
    # RANSAC, merge the closure matches into the tracks (revisited points
    # become shared 3D points) and keep the verified edges for the pose
    # graph inside run_incremental.
    closures = []
    if not args.no_loop_closure and len(res.keyframes) >= 2:
        from akaze_tpu_torch.sfm.loop_closure import detect_loop_closures, merge_closure_tracks

        with span("loop_closure", device):
            closures = detect_loop_closures(
                res.features, res.keyframes, (fx, fy, cx, cy), min_gap=args.loop_min_gap,
                min_matches=args.loop_min_matches, min_inliers=args.loop_min_inliers,
            )
            if closures:
                tracks = merge_closure_tracks(tracks, closures)

    # Track observations in normalized camera coords.
    kx = res.features.keypoints.x.cpu().numpy()
    ky = res.features.keypoints.y.cpu().numpy()
    observations = [
        {f: np.array([(kx[f, i] - cx) / fx, (ky[f, i] - cy) / fy], np.float32) for f, i in tr.items()}
        for tr in tracks
    ]
    return len(frames), len(tracks), observations, closures


if __name__ == "__main__":
    raise SystemExit(main())
