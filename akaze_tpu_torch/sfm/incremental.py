"""Mini incremental SfM of the port: tracks -> two-view init -> PnP ->
triangulation -> BA, with pose-graph optimization at loop closures and
checkpoint / resume (counterpart of the JAX package's
`akaze_tpu/sfm/incremental.py`, same scheduling and numerics).

The host owns the map bookkeeping in numpy (tracks, point-row assignment,
which keyframes see which tracks); the device owns every numeric solve on
fixed-shape padded tensors.  The host schedules a whole BA window (the
point rows each keyframe's PnP reads, the rows each keyframe triangulates
against its track's first keyframe), and `_window_superstep` runs the
window's keyframes one after another on the device: the PnP's fixed 10
steps, its fallback and the triangulation gates are `torch.where`s, so the
window reads nothing back until it ends.

Poses and points stay on the device between windows.  The host reads:
  * in the two-view init, each candidate pair's RANSAC result (its inlier
    count and pose decide the scan) and the initial triangulation;
  * per window, the validity of the point rows (the scheduler needs it),
    in one read;
  * the final poses and points, and the map at each checkpoint when
    `checkpoint_path` is given (and the poses for `on_window`).
Schedules go to the device from pinned memory without a host sync.  Each
window super-step, BA and pose graph runs in a `utils.profiling.span`
(`sfm.window`, `sfm.ba`, `sfm.pose_graph`).  Importing this module pins float32 matrix products on the GPU (no TF32).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
from akaze_tpu_torch.core.device import resolve_device, upload
from akaze_tpu_torch.geometry.twoview import estimate_relative_pose, triangulate
from akaze_tpu_torch.parallel.collectives import Mesh, all_gather, rank_rows
from akaze_tpu_torch.sfm.ba import BAProblem, bundle_adjust, bundle_adjust_sharded, project
from akaze_tpu_torch.sfm.rotations import matrix_to_rotvec, rotvec_to_matrix
from akaze_tpu_torch.utils.profiling import check_no_nan, span

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

#: cos of the triangulation parallax gate (1e-2 rad), as a float32.
_COS_PARALLAX = float(np.float32(np.cos(1e-2)))


def build_tracks(matches_ab: List[np.ndarray], num_frames: int) -> List[Dict[int, int]]:
    """Chain consecutive-frame matches into tracks.

    matches_ab[t]: (M_t, 2) int array matching frame t keypoints (col 0) to
    frame t+1 keypoints (col 1).  Returns a list of tracks, each a dict
    {frame_index: keypoint_index}, of at least two frames."""
    track_of: Dict[Tuple[int, int], int] = {}
    tracks: List[Dict[int, int]] = []
    for t, m in enumerate(matches_ab):
        for a, b in np.asarray(m):
            key = (t, int(a))
            if key in track_of:
                ti = track_of[key]
            else:
                ti = len(tracks)
                tracks.append({t: int(a)})
                track_of[key] = ti
            tracks[ti][t + 1] = int(b)
            track_of[(t + 1, int(b))] = ti
    return [tr for tr in tracks if len(tr) >= 2]


def _pnp_linearize(p: torch.Tensor, points: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor):
    """(2N,) reprojection residuals of pose p (6,) and their (2N, 6)
    Jacobian, zero where valid is 0."""
    res, jc, _ = project(p.expand(points.shape[0], 6), points, uv)
    return (res * valid[:, None]).reshape(-1), (jc * valid[:, None, None]).reshape(-1, 6)


def refine_pose_pnp(pose6: torch.Tensor, points: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                    iterations: int = 10) -> torch.Tensor:
    """Single-pose refinement from 2D-3D correspondences on their device:
    pose6 (6,), points (N, 3), uv (N, 2) normalized, valid (N,) weights.

    Each of the fixed `iterations` steps Huber-downweights the residuals
    (delta 0.01 normalized units), damps the normal equations and rejects a
    step that does not lower the robust cost (`torch.where`), so the
    refinement never leaves the warm start worse than it found it."""
    huber = 0.01

    def robust_w(r):
        """Per-correspondence Huber IRLS weights, expanded to residuals."""
        n = torch.linalg.vector_norm(r.reshape(-1, 2), dim=-1)
        w = torch.clamp(huber / torch.clamp(n, min=1e-12), max=1.0)
        return w.repeat_interleave(2)

    def cost(p):
        r = (project(p.expand(points.shape[0], 6), points, uv, jacobians=False) * valid[:, None]).reshape(-1)
        return (robust_w(r) * r * r).sum()

    eye = torch.eye(6, dtype=pose6.dtype, device=pose6.device)
    p = pose6
    c = cost(p)
    lam = torch.full((), 1e-5, dtype=pose6.dtype, device=pose6.device)
    for _ in range(iterations):
        r, j = _pnp_linearize(p, points, uv, valid)  # (2N,), (2N, 6)
        w = robust_w(r)
        jw = j * w[:, None]
        h = jw.T @ j + (lam + 1e-6) * eye
        with span("linalg", h.device):
            delta = -torch.linalg.solve_ex(h, (jw.T @ r)[:, None], check_errors=False).result[:, 0]
        cand = p + delta
        c_new = cost(cand)
        accept = torch.isfinite(c_new) & (c_new < c)
        p = torch.where(accept, cand, p)
        c = torch.where(accept, c_new, c)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0), 1e-8, 1e3)
    return p


def _rows_times(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) m and (..., 3) x -> m^T x, i.e. sum_j x_j m[j, i]."""
    return (x[..., :, None] * m).sum(-2)


def _window_superstep(poses, points, valid, ks, pnp_rows, pnp_uv, pnp_w, tri_rows, tri_anc, tri_uva, tri_uvb,
                      tri_w, pnp_iterations: int = 10):
    """Sequential PnP + triangulation over a window of keyframes, on the
    device, with no host read.

    poses (K, 6); points (Pcap + 1, 3) and valid (Pcap + 1,), whose last
    row is the padding sentinel; ks: the window's keyframe indices (host
    ints); per step s the sentinel-padded schedules pnp_rows / pnp_uv /
    pnp_w (Npnp) and tri_rows / tri_anc / tri_uva / tri_uvb / tri_w (Ntri).

    Step k: (1) PnP against the currently valid scheduled points, warm
    started from pose k-1, falling back to pose k-1 under 6 usable
    correspondences; (2) midpoint triangulation of the scheduled rows from
    (anchor, k), the anchor being the track's first keyframe; a row becomes
    valid when both depths are positive and the rotation-compensated ray
    angle clears 1e-2 rad.  Rows repeat only as the sentinel, whose
    value and validity every write leaves as they were."""
    poses, points, valid = poses.clone(), points.clone(), valid.clone()
    for s, k in enumerate(ks):
        # ---- PnP ----
        rows = pnp_rows[s]
        wv = pnp_w[s] * valid[rows].to(torch.float32)
        pose_prev = poses[k - 1]
        refined = refine_pose_pnp(pose_prev, points[rows], pnp_uv[s], wv, iterations=pnp_iterations)
        pose_k = torch.where(wv.sum() >= 6.0, refined, pose_prev)
        poses[k] = pose_k
        # ---- triangulate the scheduled tracks from (anchor, k) ----
        trows, tw = tri_rows[s], tri_w[s]
        pa = poses[tri_anc[s]]  # (Ntri, 6) anchor poses
        ra = rotvec_to_matrix(pa[:, :3])  # (Ntri, 3, 3)
        rb = rotvec_to_matrix(pose_k[:3])
        r_rel = (rb[None, :, None, :] * ra[:, None, :, :]).sum(-1)  # rb @ ra^T
        t_rel = pose_k[3:] - (r_rel * pa[:, None, 3:]).sum(-1)
        ones = torch.ones_like(tri_uva[s][:, :1])
        xa = torch.cat([tri_uva[s], ones], dim=-1)
        xb = torch.cat([tri_uvb[s], ones], dim=-1)
        local = triangulate(r_rel, t_rel, xa[:, None, :], xb[:, None, :])[:, 0]  # anchor frames
        world = _rows_times(ra, local - pa[:, 3:])
        ray_a = xa / torch.linalg.vector_norm(xa, dim=-1, keepdim=True)
        ray_b = _rows_times(r_rel, xb)  # cam-b ray in anchor axes
        ray_b = ray_b / torch.linalg.vector_norm(ray_b, dim=-1, keepdim=True)
        cosang = torch.clamp((ray_a * ray_b).sum(-1), -1.0, 1.0)
        zb = ((r_rel * local[:, None, :]).sum(-1) + t_rel)[:, 2]
        ok = (local[:, 2] > 0) & (zb > 0) & (cosang < _COS_PARALLAX) & (tw > 0) & torch.logical_not(valid[trows])
        points[trows] = torch.where(ok[:, None], world, points[trows])
        valid[trows] = valid[trows] | ok
    return poses, points, valid


def _bucket(n: int, minimum: int = 64) -> int:
    return max(minimum, 1 << max(0, (n - 1)).bit_length())


def _apply_pose_graph(poses: torch.Tensor, num_kf: int, closures, iterations: int = 12,
                      sconfig: SfmConfig | None = None):
    """Pose-graph optimization over odometry + loop-closure edges, on the
    poses' device.

    Odometry edges carry the current estimates (zero residual at the
    start); closure edges the measured relative pose, whose unit-scale
    translation is rescaled to the current estimate's baseline.  Edges are
    information-weighted (`SfmConfig.pgo_*_sigma`) and bucket-padded.
    Returns (poses, applied)."""
    from akaze_tpu_torch.sfm.pose_graph import PoseGraph, optimize_pose_graph, relative

    sconfig = sconfig or SfmConfig()
    act = [c for c in closures if c[1] < num_kf]
    if not act:
        return poses, False
    dev = poses.device
    odo = relative(poses[1:num_kf], poses[: num_kf - 1])
    ci = upload(np.array([c[0] for c in act], np.int64), dev)
    cj = upload(np.array([c[1] for c in act], np.int64), dev)
    est = relative(poses[cj], poses[ci])
    meas = upload(np.stack([np.asarray(c[2], np.float32) for c in act]), dev)
    scale = torch.clamp(torch.linalg.vector_norm(est[:, 3:], dim=-1), min=1e-6)
    closure_rel = torch.cat([meas[:, :3], meas[:, 3:] * scale[:, None]], dim=-1)
    edges_i = list(range(1, num_kf)) + [int(c[1]) for c in act]
    edges_j = list(range(0, num_kf - 1)) + [int(c[0]) for c in act]
    e = len(edges_i)
    n_odo = num_kf - 1  # odometry edges precede the closures
    ecap = _bucket(e, 16)
    K = poses.shape[0]
    fixed = np.zeros(K, bool)
    fixed[0] = True
    fixed[num_kf:] = True
    weights = np.zeros(ecap, np.float32)
    weights[:n_odo] = 1.0 / max(sconfig.pgo_odometry_sigma, 1e-9)
    weights[n_odo:e] = 1.0 / max(sconfig.pgo_closure_sigma, 1e-9)
    rel = torch.cat([odo, closure_rel, torch.zeros((ecap - e, 6), dtype=poses.dtype, device=dev)])
    graph = PoseGraph(
        poses=poses,
        edge_i=upload(np.pad(np.asarray(edges_i, np.int64), (0, ecap - e)), dev),
        edge_j=upload(np.pad(np.asarray(edges_j, np.int64), (0, ecap - e)), dev),
        rel=rel,
        valid=upload(np.arange(ecap) < e, dev),
        fixed=upload(fixed, dev),
        weight=upload(weights, dev),
    )
    return optimize_pose_graph(graph, iterations=iterations).poses, True


@dataclasses.dataclass
class SfmResult:
    poses: np.ndarray  # (K, 6) camera-from-world per keyframe
    points: np.ndarray  # (P, 3)
    keyframe_frames: List[int]  # original frame index per keyframe
    track_point: Dict[int, int]  # track index -> point row


def _closure_tuples(closures) -> List[Tuple[int, int, np.ndarray]]:
    out = []
    for c in closures or []:
        if hasattr(c, "rel6"):
            out.append((int(c.i), int(c.j), np.asarray(c.rel6, np.float32)))
        else:
            i, j, rel6 = c
            out.append((int(i), int(j), np.asarray(rel6, np.float32)))
    return out


def _pose_from_pair(res):
    """(R, t, inliers, num_inliers) of a two-view result as numpy, in one
    host read."""
    n = res.inliers.shape[-1]
    flat = torch.cat([res.R.reshape(-1), res.t, res.inliers.to(torch.float32),
                      res.num_inliers.to(torch.float32).reshape(1)]).cpu().numpy()
    return flat[:9].reshape(3, 3), flat[9:12], flat[12 : 12 + n] > 0.5, int(flat[12 + n])


def run_incremental(
    observations: List[Dict[int, np.ndarray]],
    num_frames: int,
    sconfig: SfmConfig | None = None,
    rconfig: RansacConfig | None = None,
    mesh=None,
    ba_every: int = 4,
    resume=None,
    checkpoint_path=None,
    closures=None,
    pgo_iterations: int = 12,
    on_window=None,
    device="cuda",
    draws=None,
) -> SfmResult:
    """Incremental SfM over tracked observations on `device` (the card
    unless the caller asks for the CPU).

    observations: per-track dict {frame: uv (2,) normalized coords}.  Frames
    are keyframes 0..num_frames-1.  Returns poses for every frame and the
    sparse map (numpy).

    closures: verified loop closures (`sfm.loop_closure.Closure`s or
    (i, j, rel6) tuples, i < j, rel6 the measured cam_j-from-cam_i
    [rotvec | t]).  When a window reaches a closure's later keyframe,
    pose-graph optimization runs over odometry + closure edges and bundle
    adjustment re-polishes the map from the corrected poses.

    checkpoint_path: persist the map after every BA round; resume: an
    `SfmCheckpoint` to restart from its `next_keyframe`.  on_window:
    `f(k_end, poses, num_points)` after each window (poses as numpy).

    draws: the random scores of the two-view init's RANSAC, a function
    (seed, (H, N)) -> array; None draws from a `torch.Generator` seeded with
    `rconfig.seed` for each candidate pair, as the JAX package keys each with
    `PRNGKey(rconfig.seed)`.  `interop.jax_uniform` gives JAX's draws.

    mesh: a `parallel` mesh with a `data` axis (every rank of it calls
    run_incremental with the same arguments): each BA's points are split
    over the axis (`bundle_adjust_sharded`) and gathered back, so every rank
    holds the whole map and runs the same host schedule; the run is on the
    mesh's device, and only the mesh's rank 0 writes checkpoints."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"run_incremental(mesh=...) takes a parallel.collectives.Mesh, got {type(mesh).__name__}")
    device = resolve_device(device) if mesh is None else mesh.device
    sconfig = sconfig or SfmConfig()
    rconfig = rconfig or RansacConfig()
    K = num_frames
    poses = torch.zeros((K, 6), dtype=torch.float32, device=device)
    closure_list = _closure_tuples(closures)

    # Dense point-row storage: the host assigns rows, the device decides validity.
    cap = 256
    points = torch.zeros((cap, 3), dtype=torch.float32, device=device)
    valid = np.zeros(cap, bool)
    next_row = 0
    assigned: Dict[int, int] = {}  # track -> row (valid or not yet)

    def ensure_capacity(n):
        nonlocal cap, points, valid
        if n <= cap:
            return
        new_cap = _bucket(n, cap)
        points = torch.cat([points, points.new_zeros((new_cap - cap, 3))])
        valid = np.concatenate([valid, np.zeros(new_cap - cap, bool)])
        cap = new_cap

    if resume is not None:
        if resume.next_keyframe > K:
            raise ValueError(
                f"checkpoint next_keyframe={resume.next_keyframe} exceeds num_frames={K}; the resumed run must "
                "cover at least as many frames as the checkpointed one"
            )
        start_k = resume.next_keyframe
        n = min(resume.poses.shape[0], K)
        poses[:n] = upload(np.asarray(resume.poses[:n], np.float32), device)
        rp = np.asarray(resume.points, np.float32).reshape(-1, 3)
        ensure_capacity(len(rp))
        points[: len(rp)] = upload(rp, device)
        next_row = len(rp)
        assigned = dict(resume.track_point)
        for row in assigned.values():
            valid[row] = True
    else:
        # ---- two-view initialization: the first pair (0, j) with real
        # parallax (median rotation-compensated bearing angle >= 2 deg and
        # enough inliers), else the widest pair seen. ----
        best = None
        for j in range(1, min(6, K)):
            pairs = [ti for ti, tr in enumerate(observations) if 0 in tr and j in tr]
            if len(pairs) < 8:
                continue
            x1 = np.array([np.append(observations[ti][0], 1.0) for ti in pairs], np.float32)
            x2 = np.array([np.append(observations[ti][j], 1.0) for ti in pairs], np.float32)
            scores = None if draws is None else draws(rconfig.seed, (rconfig.num_iterations, len(pairs)))
            res = estimate_relative_pose(x1, x2, np.ones(len(pairs), bool), rconfig, device=device,
                                         sample_scores=scores)
            R, t, inl, n_inl = _pose_from_pair(res)
            p1 = x1 / np.linalg.norm(x1, axis=1, keepdims=True)
            p2r = x2 @ R
            p2r /= np.linalg.norm(p2r, axis=1, keepdims=True)
            med_parallax = float(np.degrees(np.median(np.arccos(np.clip(np.sum(p1 * p2r, axis=1), -1.0, 1.0)))))
            cand = (j, pairs, x1, x2, (R, t, inl), med_parallax)
            if best is None or med_parallax > best[5]:
                best = cand
            if med_parallax >= 2.0 and n_inl >= max(8, int(0.3 * len(pairs))):
                best = cand
                break
        if best is None:
            raise ValueError("two-view initialization failed: no early frame pair shares >=8 tracks with frame 0")
        j_init, pairs, x1, x2, (R, t, inl), _ = best
        start_k = 1  # every frame >= 1 is PnP'd / refined by the window loop
        init = np.zeros((K, 6), np.float32)
        init[j_init, :3] = matrix_to_rotvec(torch.from_numpy(R)).numpy()
        init[j_init, 3:] = t  # |t| = 1 fixes the gauge scale
        # Frames before j_init warm-start from the init pose scaled linearly.
        for k in range(1, j_init):
            init[k] = init[j_init] * (k / j_init)
        poses = upload(init, device)

        # Map: triangulate the init inliers on the device.
        pts3 = triangulate(upload(R, device), upload(t, device), upload(x1, device),
                           upload(x2, device)).cpu().numpy()
        good = inl & (pts3[:, 2] > 0)
        ensure_capacity(int(good.sum()))
        init_pts = np.zeros((cap, 3), np.float32)
        for row, (ti, g) in enumerate(zip(pairs, good)):
            if g:
                assigned[ti] = next_row
                init_pts[next_row] = pts3[row]
                valid[next_row] = True
                next_row += 1
        points = upload(init_pts, device)

    # Index tracks by frame once (host, O(total observations)).
    frame_tracks: List[List[int]] = [[] for _ in range(K)]
    for ti, tr in enumerate(observations):
        for f in tr:
            if f < K:
                frame_tracks[f].append(ti)

    # ---- window loop: each window = one device super-step + one BA ----
    k = start_k
    while k < K:
        k_end = k
        while k_end < K - 1 and not (k_end % ba_every == 0 and k_end >= k):
            k_end += 1
        window = list(range(k, k_end + 1))

        # Host scheduling: per keyframe, PnP rows + triangulation pairs.
        pnp_sched: List[List[Tuple[int, np.ndarray]]] = []
        tri_sched: List[List[Tuple[int, int, np.ndarray, np.ndarray]]] = []
        assign_step: Dict[int, int] = {}  # window step at which a track got its row
        for wi, kk in enumerate(window):
            pnp_k = []
            for ti in frame_tracks[kk]:
                if ti in assigned and (ti not in assign_step or assign_step[ti] < wi):
                    pnp_k.append((assigned[ti], observations[ti][kk]))
            tri_k = []
            for ti in frame_tracks[kk]:
                tr = observations[ti]
                anchor = min(tr)  # the track's first keyframe
                if anchor >= kk:
                    continue
                if ti in assigned:
                    row = assigned[ti]
                    # Reschedule only failed rows (the device skips valid ones).
                    if valid[row] or ti in assign_step:
                        if ti not in assign_step:
                            continue  # valid from a previous window
                    tri_k.append((row, anchor, tr[anchor], tr[kk]))
                else:
                    ensure_capacity(next_row + 1)
                    assigned[ti] = next_row
                    assign_step[ti] = wi
                    tri_k.append((next_row, anchor, tr[anchor], tr[kk]))
                    next_row += 1
            pnp_sched.append(pnp_k)
            tri_sched.append(tri_k)

        W = len(window)
        n_pnp = _bucket(max((len(p) for p in pnp_sched), default=1))
        n_tri = _bucket(max((len(t) for t in tri_sched), default=1))
        pcap = _bucket(next_row, cap)
        ensure_capacity(pcap)
        sentinel = pcap  # the device arrays get one extra padding row

        pnp_rows = np.full((W, n_pnp), sentinel, np.int64)
        pnp_uv = np.zeros((W, n_pnp, 2), np.float32)
        pnp_w = np.zeros((W, n_pnp), np.float32)
        tri_rows = np.full((W, n_tri), sentinel, np.int64)
        tri_anc = np.zeros((W, n_tri), np.int64)
        tri_uva = np.zeros((W, n_tri, 2), np.float32)
        tri_uvb = np.zeros((W, n_tri, 2), np.float32)
        tri_w = np.zeros((W, n_tri), np.float32)
        for wi in range(W):
            for s, (row, uv) in enumerate(pnp_sched[wi]):
                pnp_rows[wi, s] = row
                pnp_uv[wi, s] = uv
                pnp_w[wi, s] = 1.0
            for s, (row, anchor, uva, uvb) in enumerate(tri_sched[wi]):
                tri_rows[wi, s] = row
                tri_anc[wi, s] = anchor
                tri_uva[wi, s] = uva
                tri_uvb[wi, s] = uvb
                tri_w[wi, s] = 1.0

        dev_points = torch.cat([points[:pcap], points.new_zeros((1, 3))])
        dev_valid = upload(np.concatenate([valid[:pcap], np.zeros(1, bool)]), device)
        sched = [upload(a, device) for a in (pnp_rows, pnp_uv, pnp_w, tri_rows, tri_anc, tri_uva, tri_uvb,
                                                  tri_w)]
        with span("sfm.window", device):
            poses, out_points, out_valid = _window_superstep(poses, dev_points, dev_valid, window, *sched)
        points[:pcap] = out_points[:pcap]
        valid[:pcap] = out_valid[:pcap].cpu().numpy()  # the window's one host read

        # ---- bundle adjustment over everything so far ----
        track_point = {ti: row for ti, row in assigned.items() if valid[row]}
        if next_row >= 8:
            with span("sfm.ba", device):
                poses, points[:next_row] = _run_ba(poses, points[:next_row], observations, track_point, k_end + 1,
                                                   sconfig, mesh)
            # Pose-graph optimization when this window reached a closure's
            # later keyframe; BA then re-polishes from the corrected poses.
            if any(k <= cj <= k_end for _, cj, _ in closure_list):
                with span("sfm.pose_graph", device):
                    poses, applied = _apply_pose_graph(poses, k_end + 1, closure_list, pgo_iterations, sconfig)
                if applied:
                    with span("sfm.ba", device):
                        poses, points[:next_row] = _run_ba(poses, points[:next_row], observations, track_point,
                                                           k_end + 1, sconfig, mesh)
            if checkpoint_path is not None and (mesh is None or mesh.rank == 0):
                from akaze_tpu_torch.sfm.checkpoint import SfmCheckpoint, save_checkpoint

                save_checkpoint(checkpoint_path, SfmCheckpoint(
                    poses=poses.cpu().numpy(), points=points[:next_row].cpu().numpy(), track_point=track_point,
                    keyframe_frames=list(range(k_end + 1)), next_keyframe=k_end + 1,
                ))
        if on_window is not None:
            on_window(k_end, poses.cpu().numpy(), next_row)
        k = k_end + 1

    check_no_nan("run_incremental", poses, points[:next_row])
    track_point = {ti: row for ti, row in assigned.items() if valid[row]}
    return SfmResult(poses=poses.cpu().numpy(), points=points[:next_row].cpu().numpy(),
                     keyframe_frames=list(range(K)), track_point=track_point)


def _run_ba(poses: torch.Tensor, points: torch.Tensor, observations, track_point, num_kf: int,
            sconfig: SfmConfig, mesh: Mesh | None = None):
    """Pack the current map into a fixed-shape BAProblem on the poses'
    device and optimize; returns (poses, points) on the device.

    Rows without a valid track get no observations and stay where they
    are.  Each point keeps up to `ba_obs_per_point` observations spread
    evenly over its track (its first and last keyframe included), and the
    point count is padded to the next power of two, rounded up to a multiple
    of the mesh's `data` size; with a mesh each rank optimizes its block of
    rows and the blocks are gathered back on every rank."""
    device = poses.device
    P = points.shape[0]
    Q = max(2, min(sconfig.ba_obs_per_point, num_kf))
    bucket = max(64, 1 << (P - 1).bit_length())
    if mesh is not None:
        n = mesh.axis_size("data")
        bucket = -(-bucket // n) * n
    obs_cam = np.zeros((bucket, Q), np.int64)
    obs_uv = np.zeros((bucket, Q, 2), np.float32)
    obs_valid = np.zeros((bucket, Q), bool)
    for ti, row in track_point.items():
        tr = observations[ti]
        frames = [f for f in sorted(tr) if f < num_kf]
        if len(frames) > Q:
            idx = np.round(np.linspace(0, len(frames) - 1, Q)).astype(int)
            frames = [frames[i] for i in dict.fromkeys(idx)]
        for q, f in enumerate(frames):
            obs_cam[row, q] = f
            obs_uv[row, q] = tr[f]
            obs_valid[row, q] = True
    # Gauge: pose 0 pins the frame; the monocular scale is left to the LM
    # damping.  Future slots stay untouched.
    fixed = np.zeros(poses.shape[0], bool)
    fixed[0] = True
    fixed[num_kf:] = True
    problem = BAProblem(
        poses=poses,
        points=torch.cat([points, points.new_zeros((bucket - P, 3))]),
        obs_cam=upload(obs_cam, device),
        obs_uv=upload(obs_uv, device),
        obs_valid=upload(obs_valid, device),
        fixed=upload(fixed, device),
    )
    if mesh is None:
        out = bundle_adjust(problem, sconfig)
        return out.poses, out.points[:P]
    out = bundle_adjust_sharded(problem.rows(rank_rows(bucket, mesh)), sconfig, mesh)
    return out.poses, all_gather([out.points], mesh)[0][:P]
