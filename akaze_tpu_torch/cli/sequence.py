"""`python -m akaze_tpu_torch.cli.sequence`: the batched video front end
over a frame sequence (extraction, consecutive matching, keyframes), on
the card unless --device cpu."""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np


def load_frames(path: str) -> np.ndarray:
    """(T, H, W) float32 frames from .npy/.npz, or a directory of images."""
    from akaze_tpu_torch.cli.imgio import load_gray

    p = pathlib.Path(path)
    if p.is_dir():
        files = sorted(f for f in p.iterdir() if f.suffix.lower() in (".npy", ".pgm", ".png", ".jpg", ".jpeg"))
        return np.stack([load_gray(f) for f in files])
    if p.suffix.lower() == ".npz":
        with np.load(p) as z:
            return np.asarray(z[z.files[0]], np.float32)
    return np.asarray(np.load(p), np.float32)


def main(argv=None) -> int:
    from akaze_tpu_torch.cli.extract import add_config_args, build_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames", help="(T,H,W) .npy/.npz or a directory of images")
    p.add_argument("-o", "--output", required=True, help="output .json summary")
    add_config_args(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--keyframe-min-tracked", type=float, default=0.6)
    p.add_argument("--features-out", help="optional .npz with all features")
    args = p.parse_args(argv)

    import torch

    from akaze_tpu_torch.core.config import SfmConfig
    from akaze_tpu_torch.core.device import resolve_device
    from akaze_tpu_torch.interop import features_to_numpy
    from akaze_tpu_torch.matching.video import process_video
    from akaze_tpu_torch.utils.profiling import MetricsLogger, SpanRecorder, record_spans, span

    device = resolve_device(args.device)
    frames = load_frames(args.frames)
    metrics = MetricsLogger()
    with record_spans(SpanRecorder()) as rec, span("process_video", device):
        res = process_video(
            frames,
            build_config(args),
            sconfig=SfmConfig(keyframe_min_tracked=args.keyframe_min_tracked),
            batch=args.batch,
            device=device,
        )
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the one sync: the span's events are read
    t = rec.seconds("process_video")
    fps = len(frames) / t
    arrays = features_to_numpy(res.features)
    kp_counts = arrays["valid"].sum(axis=1)
    metrics.log(
        "sequence_done", frames=len(frames), fps=round(fps, 2),
        keyframes=len(res.keyframes),
        mean_keypoints=float(kp_counts.mean()),
        mean_matches=float(res.match_counts[1:].mean() if len(frames) > 1 else 0),
    )
    summary = {
        "num_frames": int(len(frames)),
        "fps": fps,
        "keyframes": res.keyframes,
        "keypoints_per_frame": kp_counts.tolist(),
        "matches_to_prev": res.match_counts.tolist(),
    }
    pathlib.Path(args.output).write_text(json.dumps(summary, indent=1))
    if args.features_out:
        np.savez_compressed(args.features_out, **arrays)
    print(f"{len(frames)} frames @ {fps:.1f} fps, {len(res.keyframes)} keyframes -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
