"""Run the incremental SfM of one package on a synthetic scene, on the CPU
or the card, and print its ATE after every BA window and at the end.

    python tools/sfm_parity.py jax 200 2000 --loop --noise 2e-3 --save jax.npz
    python tools/sfm_parity.py port 200 2000 --loop --noise 2e-3 [--device cuda] --save port.npz
    python tools/sfm_parity.py compare jax.npz port.npz   # camera centers, max |diff|, by window
    python tools/sfm_parity.py port 50 600 --threads 1 --save t1.npz   # the same run, summed in another order
    python tools/sfm_parity.py ba-probe 3   # JAX's first 3 BA problems of the 200-kf loop scene

ba-probe (JAX and the port on the CPU) catches the BA problems the JAX
package builds in its first windows of sfm_scene(200, 5000, loop=True,
noise 2e-3) and runs on each: JAX's float32 BA, the port's float32 and
float64 BA, and both float32 BAs again on uv perturbed by 1e-7 relative; it
prints the scale of each result's camera centers relative to JAX's (the
monocular scale is the BA's weakest direction).

Both read `sfm_scene(K, P, seed, loop, obs_noise)` with its closures,
SfmConfig(ba_iterations=8), RansacConfig(256, 5e-3) and ba_every=8 (the
bench's SfM configuration); the port draws the two-view init's random
scores as JAX does (`interop.jax_uniform`) unless --own-draws.  The scene is
chaotic under float32 rounding (window ATEs of the two packages part after
~100 keyframes), so compare the two histories, not single numbers.
"""

from __future__ import annotations

import argparse
import time


def main() -> int:
    import sys

    import numpy as np

    from akaze_tpu_torch.sfm.metrics import ate_rmse, camera_centers, umeyama_align

    if sys.argv[1:2] == ["ba-probe"]:
        return ba_probe(int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    if sys.argv[1:2] == ["compare"]:
        a, b = (np.load(f) for f in sys.argv[2:4])
        for k, pa, pb in zip(a["window_k"], a["window_poses"], b["window_poses"]):
            ca, cb = camera_centers(pa[: k + 1]), camera_centers(pb[: k + 1])
            d = np.abs(ca - cb).max(axis=1)
            line = f"window to keyframe {k}: camera centers max |diff| {d.max():.3e} (keyframe {int(d.argmax())})"
            if np.isfinite(ca).all() and np.isfinite(cb).all():
                # The monocular scale is free (left to the LM damping), so
                # also compare after a similarity alignment of b onto a.
                sc, r, t = umeyama_align(cb, ca)
                da = np.linalg.norm((sc * (r @ cb.T)).T + t - ca, axis=1)
                line += f"; aligned max {da.max():.3e}, rmse {np.sqrt((da ** 2).mean()):.3e}, scale {sc:.5f}"
            print(line)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("keyframes", type=int)
    ap.add_argument("points", type=int)
    ap.add_argument("--save", help="write the poses after each window to this .npz")
    ap.add_argument("--loop", action="store_true")
    ap.add_argument("--noise", type=float, default=5e-4)
    ap.add_argument("--prefix", type=int, help="run only the first N keyframes of the scene")
    ap.add_argument("--no-closures", action="store_true")
    ap.add_argument("--own-draws", action="store_true", help="port: its own torch.Generator draws")
    ap.add_argument("--device", default="cpu", help="port: torch device")
    ap.add_argument("--threads", type=int, help="port: torch CPU threads (another float32 summation order)")
    args = ap.parse_args()

    kw = {}
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from akaze_tpu.core.config import RansacConfig, SfmConfig
        from akaze_tpu.sfm.incremental import run_incremental
        from akaze_tpu.utils.synthetic import sfm_scene
    else:
        from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
        from akaze_tpu_torch.interop import jax_uniform
        from akaze_tpu_torch.sfm.incremental import run_incremental
        from akaze_tpu_torch.utils.synthetic import sfm_scene

        kw = dict(device=args.device, draws=None if args.own_draws else jax_uniform)
        if args.threads:
            import torch

            torch.set_num_threads(args.threads)
    gt, obs, closures = sfm_scene(args.keyframes, args.points, seed=0, loop=args.loop, obs_noise=args.noise)
    n = args.prefix or args.keyframes
    history, window_poses = [], []

    def on_window(k, poses, _):
        window_poses.append(np.array(poses))
        poses = np.asarray(poses)[: k + 1]
        ate = ate_rmse(camera_centers(poses), camera_centers(gt[: k + 1])) if np.isfinite(poses).all() else np.nan
        history.append((k, ate))
        print(f"window to keyframe {k}: ATE {ate:.4f} ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    res = run_incremental(obs, n, SfmConfig(ba_iterations=8), RansacConfig(num_iterations=256, inlier_threshold=5e-3),
                          ba_every=8, closures=None if args.no_closures else closures or None, on_window=on_window,
                          **kw)
    wall = time.perf_counter() - t0
    finite = np.isfinite(res.poses).all()
    ate = ate_rmse(camera_centers(res.poses), camera_centers(gt[:n])) if finite else np.nan
    print(f"{args.package} {n} keyframes of sfm_scene({args.keyframes}, {args.points}, loop={args.loop}, "
          f"noise={args.noise}): {wall:.1f} s, ATE {ate:.5f}, {len(res.track_point)} valid points")
    print("ATE by window:", ", ".join(f"{k}: {a:.4f}" for k, a in history))
    if args.save:
        np.savez(args.save, window_k=np.array([k for k, _ in history]), window_poses=np.stack(window_poses))
    return 0


def ba_probe(windows: int) -> int:
    import dataclasses

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    import akaze_tpu.sfm.incremental as jinc
    from akaze_tpu.core.config import RansacConfig, SfmConfig
    from akaze_tpu.sfm.ba import BAProblem as JaxProblem
    from akaze_tpu.utils.synthetic import sfm_scene
    from akaze_tpu_torch import interop
    from akaze_tpu_torch.core.config import SfmConfig as PortConfig
    from akaze_tpu_torch.sfm import ba
    from akaze_tpu_torch.sfm.metrics import camera_centers, umeyama_align

    caught, real = [], jinc.bundle_adjust

    class Caught(Exception):
        pass

    def catch(problem, config):
        out = real(problem, config)
        caught.append(({f.name: np.asarray(getattr(problem, f.name)) for f in dataclasses.fields(problem)},
                       np.asarray(out.poses)))
        if len(caught) == windows:
            raise Caught
        return out

    jinc.bundle_adjust = catch
    _, obs, closures = sfm_scene(200, 5000, seed=0, loop=True, obs_noise=2e-3)
    try:
        jinc.run_incremental(obs, 200, SfmConfig(ba_iterations=8), RansacConfig(num_iterations=256, inlier_threshold=5e-3),
                             ba_every=8, closures=closures)
    except Caught:
        pass
    finally:
        jinc.bundle_adjust = real
    rng = np.random.default_rng(0)
    for i, (fields, jax_poses) in enumerate(caught):
        n = int((~fields["fixed"]).sum()) + 1
        ref = camera_centers(jax_poses[:n])
        scale = lambda poses: 1.0 / umeyama_align(camera_centers(np.asarray(poses, np.float32)[:n]), ref)[0]

        def port(f, dtype):
            problem = interop.ba_problem_from_numpy(f, device="cpu")
            problem = problem.replace(**{k: getattr(problem, k).to(dtype) for k in ("poses", "points", "obs_uv")})
            return ba._lm_loop(problem, PortConfig(ba_iterations=8)).poses.numpy()

        pert = dict(fields, obs_uv=(fields["obs_uv"] * (1 + 1e-7 * rng.standard_normal(fields["obs_uv"].shape)))
                    .astype(np.float32))
        jax_pert = np.asarray(real(JaxProblem(**{k: jnp.asarray(v) for k, v in pert.items()}),
                                   SfmConfig(ba_iterations=8)).poses)
        print(f"BA {i + 1} ({n} free poses of 200, {fields['points'].shape[0]} point rows), scale against JAX float32: "
              f"JAX input {scale(fields['poses']):.5f}, port float32 {scale(port(fields, torch.float32)):.5f}, "
              f"port float64 {scale(port(fields, torch.float64)):.5f}; uv * (1 + 1e-7 noise): JAX float32 "
              f"{scale(jax_pert):.5f}, port float32 {scale(port(pert, torch.float32)):.5f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
