"""`python -m akaze_tpu_torch.cli.match`: extract and match two images,
optionally with the RANSAC essential-matrix pose, on the card unless
--device cpu."""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None) -> int:
    from akaze_tpu_torch.cli.extract import add_config_args, build_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("-o", "--output", help="write matches JSON here (default stdout)")
    add_config_args(p)
    p.add_argument("--ratio", type=float, default=0.8, help="Lowe ratio threshold")
    p.add_argument("--no-mutual", action="store_true")
    p.add_argument("--pose", action="store_true", help="run RANSAC essential-matrix pose on the matches")
    p.add_argument("--intrinsics", type=float, nargs=4, metavar=("FX", "FY", "CX", "CY"),
                   help="camera intrinsics for --pose (default: fx=fy=W, c=center)")
    p.add_argument("--viz", help="write a side-by-side match visualization image (.pgm/.png)")
    args = p.parse_args(argv)

    from akaze_tpu_torch.cli.imgio import load_gray
    from akaze_tpu_torch.core.config import MatchConfig, RansacConfig
    from akaze_tpu_torch.core.device import resolve_device
    from akaze_tpu_torch.frontend.pipeline import extract
    from akaze_tpu_torch.interop import features_to_numpy
    from akaze_tpu_torch.matching.hamming import match_features

    device = resolve_device(args.device)
    cfg = build_config(args)
    img_a = load_gray(args.image_a)
    img_b = load_gray(args.image_b)
    fa = extract(img_a, cfg, device=device)
    fb = extract(img_b, cfg, device=device)
    res = match_features(fa, fb, MatchConfig(ratio=args.ratio, mutual=not args.no_mutual), device=device)

    ka, kb = features_to_numpy(fa), features_to_numpy(fb)
    acc = res.accepted.cpu().numpy()
    idx_b = res.idx_b.cpu().numpy()
    dist = res.distance.cpu().numpy()
    ia = np.nonzero(acc)[0]
    ib = idx_b[ia]
    out = {
        "num_keypoints_a": int(ka["valid"].sum()),
        "num_keypoints_b": int(kb["valid"].sum()),
        "num_matches": int(len(ia)),
        "matches": [
            {"a": int(i), "b": int(j), "distance": int(dist[i]),
             "xa": float(ka["x"][i]), "ya": float(ka["y"][i]),
             "xb": float(kb["x"][j]), "yb": float(kb["y"][j])}
            for i, j in zip(ia, ib)
        ],
    }

    if args.pose:
        from akaze_tpu_torch.geometry.twoview import estimate_relative_pose, normalize_points

        h, w = img_a.shape
        intr = tuple(args.intrinsics) if args.intrinsics else (float(w), float(w), w / 2.0, h / 2.0)
        x1 = normalize_points(fa.keypoints.x, fa.keypoints.y, intr)
        x2 = normalize_points(fb.keypoints.x[res.idx_b.long()], fb.keypoints.y[res.idx_b.long()], intr)
        pose = estimate_relative_pose(x1, x2, res.accepted, RansacConfig(), device=device)
        out["pose"] = {
            "R": pose.R.cpu().numpy().tolist(),
            "t": pose.t.cpu().numpy().tolist(),
            "E": pose.E.cpu().numpy().tolist(),
            "num_inliers": int(pose.num_inliers),
        }

    if args.viz:
        from akaze_tpu_torch.cli.viz import render_matches, save_image

        va, vb = ka["valid"], kb["valid"]
        # Accepted match indices are slot indices and the valid slots may
        # have holes, so map slots to positions among the valid keypoints.
        pos_a = np.cumsum(va) - 1
        pos_b = np.cumsum(vb) - 1
        pairs = np.stack([pos_a[ia], pos_b[ib]], axis=1) if len(ia) else np.zeros((0, 2), np.int64)
        canvas = render_matches(
            img_a, img_b,
            ka["x"][va], ka["y"][va], ka["size"][va],
            kb["x"][vb], kb["y"][vb], kb["size"][vb],
            pairs,
        )
        save_image(args.viz, canvas)

    text = json.dumps(out, indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"{out['num_matches']} matches -> {args.output}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
