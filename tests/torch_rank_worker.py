"""One rank of the port's parallel paths, for the multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_multiprocess.py).

    python tests/torch_rank_worker.py JOB RANK WORLD PORT WORKDIR

Each rank joins a process group on tcp://127.0.0.1:PORT (gloo on the CPU
or where ranks share a card), runs JOB with one CPU thread on the device
the test names ("cpu" unless in.pkl says otherwise), reads its inputs from WORKDIR/in.npz (and
WORKDIR/in.pkl for Python structures, written by the test) and writes rank
0's results to WORKDIR/out.npz.  It imports nothing of JAX, as a rank on a
machine without JAX would not.
"""

import os
import pickle
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from akaze_tpu_torch import interop  # noqa: E402
from akaze_tpu_torch.core.config import SfmConfig  # noqa: E402
from akaze_tpu_torch.parallel import distributed  # noqa: E402
from akaze_tpu_torch.parallel.collectives import all_gather  # noqa: E402
from akaze_tpu_torch.parallel.mesh import (  # noqa: E402
    extract_batch_sharded, gather_features, make_mesh, total_valid_keypoints,
)
from akaze_tpu_torch.sfm.ba import bundle_adjust_sharded  # noqa: E402


def _ba(problem, mesh, iterations):
    """bundle_adjust_sharded of the whole `problem` cut into the mesh's
    shards; the whole result (poses, points) on every rank."""
    shard = interop.ba_problem_shards(problem, mesh.size)[mesh.rank]
    out = bundle_adjust_sharded(shard, SfmConfig(ba_iterations=iterations), mesh)
    return out.poses, all_gather([out.points], mesh)[0]


def main():
    job, rank, world, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    work = Path(sys.argv[5])
    torch.set_num_threads(1)
    arrays = dict(np.load(work / "in.npz")) if (work / "in.npz").exists() else {}
    extra = pickle.loads((work / "in.pkl").read_bytes()) if (work / "in.pkl").exists() else {}
    device = extra.get("device", "cpu")
    distributed.initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, device=device, timeout_s=60)
    out = {}
    if job == "extract":
        mesh = make_mesh(world, device=device)
        cfg = interop.config_from_fields(extra["config"])
        feats = extract_batch_sharded(arrays["frames"], mesh, cfg)
        out = interop.features_to_numpy(gather_features(feats, mesh))
        out["total_valid"] = np.int64(total_valid_keypoints(feats, mesh))
    elif job == "fed":
        from akaze_tpu_torch.parallel.spatial import sharded_fed_cycle

        mesh = make_mesh(world, device=device)
        block = sharded_fed_cycle(arrays["lt"], arrays["g"], [float(t) for t in arrays["taus"]], mesh)
        out["lt"] = all_gather([block], mesh)[0].cpu().numpy()
    elif job == "ba":
        mesh = make_mesh(world, device=device)
        problem = interop.ba_problem_from_numpy(arrays, device=mesh.device)
        runs = [_ba(problem, mesh, int(extra["iterations"])) for _ in range(2)]
        out = {"poses": runs[0][0].cpu().numpy(), "points": runs[0][1].cpu().numpy(),
               "rerun_equal": np.bool_(all(torch.equal(a, b) for a, b in zip(*runs)))}
    elif job == "sfm":
        from akaze_tpu_torch.sfm.incremental import run_incremental

        mesh = make_mesh(world, device=device)
        res = run_incremental(extra["observations"], extra["num_frames"], mesh=mesh, draws=interop.jax_uniform,
                              **extra["kwargs"])
        out = {"poses": res.poses, "points": res.points, "valid_tracks": np.array(sorted(res.track_point))}
    elif job == "pipeline":
        from akaze_tpu_torch.parallel.pipeline_stage import make_stage_mesh, pipelined_stream

        mesh = make_stage_mesh(world // 3, device=device)
        seed = extra["rconfig"]["seed"]
        res = pipelined_stream(arrays["frames"], mesh, *(interop.config_from_fields(extra[k])
                                                        for k in ("config", "mconfig", "rconfig")),
                               microbatch=extra["microbatch"], intr=extra["intr"],
                               draws=lambda f, shape: interop.jax_uniform(seed, shape, fold_in=f))
        out = {"match_counts": res["match_counts"], "pose_inliers": res["pose_inliers"]}
    elif job == "sfm_paced":
        # tests/test_fault_injection.py's worker: a checkpoint after every
        # window, then a pause in which the test kills this process.
        from akaze_tpu_torch.core.config import RansacConfig
        from akaze_tpu_torch.sfm.incremental import run_incremental

        def pace(k_end, poses, n_points):
            print(f"WINDOW {k_end}", flush=True)
            time.sleep(0.8)

        run_incremental(extra["observations"], 14, SfmConfig(ba_iterations=6),
                        RansacConfig(num_iterations=128, inlier_threshold=5e-3), ba_every=3,
                        checkpoint_path=str(work / "map.npz"), on_window=pace, device=device)
    elif job in ("pair", "pair_crash", "trio_crash", "duo_resume", "solo"):
        # tests/test_multiprocess.py's modes: two rounds of the sharded BA
        # with a checkpoint between them; the crash modes sleep after round
        # 1 for the test to kill a peer, the resume modes run round 2 from
        # the checkpoint on a smaller world.
        mesh = make_mesh(world, device=device)
        problem = interop.ba_problem_from_numpy(arrays, device=mesh.device)
        ckpt = work / "ckpt.npz"
        if job in ("duo_resume", "solo"):
            with np.load(ckpt) as state:
                problem = problem.replace(poses=torch.from_numpy(state["poses"]).to(mesh.device),
                                          points=torch.from_numpy(state["points"]).to(mesh.device))
        else:
            poses1, points1 = _ba(problem, mesh, 6)
            if rank == 0:
                np.savez(work / "ckpt.tmp.npz", poses=poses1.cpu().numpy(), points=points1.cpu().numpy())
                os.replace(work / "ckpt.tmp.npz", ckpt)
            print("ROUND1 done", flush=True)
            if job.endswith("crash"):
                time.sleep(2.5)  # the window in which the test kills a peer
            problem = problem.replace(poses=poses1, points=points1)
        out["poses"] = _ba(problem, mesh, 6)[0].cpu().numpy()
    else:
        raise SystemExit(f"unknown job {job}")
    if rank == 0:
        np.savez(work / "out.tmp.npz", **out)
        os.replace(work / "out.tmp.npz", work / "out.npz")
    distributed.shutdown()
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
