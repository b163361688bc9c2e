"""How the two-view pose error on multi_plane_pair depends on RANSAC's
random draws, in the JAX package and in the PyTorch port, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/twoview_draw_sweep.py [--draws 24]

For each scene seed 5-8 (240x320, as tests/test_two_view_bound.py) it runs
RansacConfig(num_iterations=512, inlier_threshold=2e-3) with `--draws`
random streams and prints, per scene, the errors of stream 0 and how many
streams miss the reference bound (rotation 1.5 deg, t-direction 6 deg):
  - jax: the JAX package end to end, keys PRNGKey(0..draws-1);
  - port+jax draws: the port's CPU correspondences and RANSAC on the same
    JAX draws (interop.jax_uniform);
  - port own: the port's CPU correspondences and RANSAC on its own CPU
    generator, seeds 0..draws-1.
"""

from __future__ import annotations

import argparse

import jax
import numpy as np
import torch

from akaze_tpu.core.config import RansacConfig as JaxRansacConfig
from akaze_tpu.frontend.pipeline import extract_batch as jax_extract_batch
from akaze_tpu.geometry import twoview as J
from akaze_tpu.matching.hamming import match_features as jax_match_features
from akaze_tpu_torch.core.config import RansacConfig
from akaze_tpu_torch.frontend.pipeline import extract_batch
from akaze_tpu_torch.geometry import twoview as T
from akaze_tpu_torch.interop import jax_uniform
from akaze_tpu_torch.matching.hamming import match_features
from akaze_tpu_torch.utils.synthetic import multi_plane_pair


def errors(R, t, R_gt, t_gt):
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    rot = np.degrees(np.arccos(np.clip((np.trace(R @ R_gt.T) - 1) / 2, -1, 1)))
    return rot, np.degrees(np.arccos(np.clip(abs(t @ t_gt), -1, 1)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=24)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    cfg = RansacConfig(num_iterations=512, inlier_threshold=2e-3)
    jcfg = JaxRansacConfig(num_iterations=512, inlier_threshold=2e-3)
    for seed in (5, 6, 7, 8):
        img_a, img_b, R_gt, t_gt, intr = multi_plane_pair(seed=seed)
        f = extract_batch(np.stack([img_a, img_b]), device="cpu")
        m = match_features(f.index(0), f.index(1), device="cpu")
        idx = m.idx_b.long()
        x1 = T.normalize_points(f.keypoints.x[0], f.keypoints.y[0], intr)
        x2 = T.normalize_points(f.keypoints.x[1][idx], f.keypoints.y[1][idx], intr)
        jf = jax_extract_batch(np.stack([img_a, img_b]))
        jm = jax_match_features(jax.tree.map(lambda x: x[0], jf), jax.tree.map(lambda x: x[1], jf))
        jx1 = J.normalize_points(jf.keypoints.x[0], jf.keypoints.y[0], intr)
        jx2 = J.normalize_points(jf.keypoints.x[1][jm.idx_b], jf.keypoints.y[1][jm.idx_b], intr)
        runs = {"jax": [], "port+jax draws": [], "port own": []}
        for k in range(args.draws):
            r = J.estimate_relative_pose(jx1, jx2, jm.accepted, jcfg, jax.random.PRNGKey(k))
            runs["jax"].append(errors(r.R, r.t, R_gt, t_gt))
            g = torch.from_numpy(jax_uniform(k, (cfg.num_iterations, x1.shape[0])))
            r = T.estimate_relative_pose_fn(x1, x2, m.accepted, cfg, sample_scores=g)
            runs["port+jax draws"].append(errors(r.R, r.t, R_gt, t_gt))
            r = T.estimate_relative_pose_fn(x1, x2, m.accepted, cfg, generator=torch.Generator().manual_seed(k))
            runs["port own"].append(errors(r.R, r.t, R_gt, t_gt))
        print(f"scene seed {seed}: {int(m.count())} port matches, {int(jm.count())} JAX matches")
        for name, e in runs.items():
            e = np.asarray(e)
            miss = int(((e[:, 0] > 1.5) | (e[:, 1] > 6.0)).sum())
            print(f"  {name:15s} draw 0: rot {e[0, 0]:.3f} t-dir {e[0, 1]:.3f} deg; {miss} of {len(e)} draws miss "
                  f"1.5 / 6 deg; median rot {np.median(e[:, 0]):.3f} t-dir {np.median(e[:, 1]):.3f}, max rot "
                  f"{e[:, 0].max():.3f} t-dir {e[:, 1].max():.3f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
