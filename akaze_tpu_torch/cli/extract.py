"""`python -m akaze_tpu_torch.cli.extract`: image in -> keypoints and
descriptors out (.json or .npz), on the card unless --device cpu."""

from __future__ import annotations

import argparse
import sys
import time

from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity


def build_config(args) -> AkazeConfig:
    return AkazeConfig(
        num_octaves=args.octaves,
        num_sublevels=args.sublevels,
        detector_threshold=args.threshold,
        diffusivity=Diffusivity(args.diffusivity),
        max_keypoints=args.max_keypoints,
    )


def add_config_args(p: argparse.ArgumentParser) -> None:
    """The AKAZE options of every CLI, and the device to run on."""
    p.add_argument("--octaves", type=int, default=4)
    p.add_argument("--sublevels", type=int, default=4)
    p.add_argument("--threshold", type=float, default=1e-3)
    p.add_argument("--diffusivity", choices=[d.value for d in Diffusivity], default=Diffusivity.PM_G2.value)
    # The library default, so the CLI and the library extract the same features.
    p.add_argument("--max-keypoints", type=int, default=AkazeConfig.max_keypoints)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image", help="input image (.npy/.npz/.pgm, or PIL formats)")
    p.add_argument("output", help="feature file (.json or .npz)")
    add_config_args(p)
    p.add_argument("--timing", action="store_true", help="log the extract time")
    args = p.parse_args(argv)

    from akaze_tpu_torch.cli.imgio import load_gray, save_features
    from akaze_tpu_torch.core.device import resolve_device
    from akaze_tpu_torch.frontend.pipeline import extract

    device = resolve_device(args.device)
    img = load_gray(args.image)
    t0 = time.perf_counter()
    feats = extract(img, build_config(args), device=device)
    n = int(feats.keypoints.count())  # waits for the device
    t1 = time.perf_counter()
    save_features(args.output, feats)
    if args.timing:
        print(f"extract: {img.shape[1]}x{img.shape[0]} -> {n} keypoints in {t1 - t0:.3f}s "
              "(incl. the kernel build on first use)", file=sys.stderr)
    print(f"{n} keypoints -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
