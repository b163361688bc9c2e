#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akaze_tpu_torch) on one GPU.

    python3 chip_smoke.py [--batch 128] [--reps 3]

1. Prints the card (nvidia-smi name and power limit), the torch / CUDA /
   nvcc versions, and builds the seven kernels, the NMS, the top-K and the
   contrast-factor kernel from akaze_tpu_torch/csrc (all nvcc processes
   in parallel), timing the build and printing each __global__ function's
   registers and spills as ptxas reports them.
2. Holds each kernel against its plain PyTorch twin on the card, on the
   inputs its path gives it (kernels 1-4, 7, the NMS, the top-K and the
   contrast factor: batch VGA frames, the top-K and the contrast factor
   also on 128 KITTI frames; kernels 5 and 6: single VGA frames of the
   per-level path), with the stated tolerances (kernels 1, 3, 4, 6, 7, the
   NMS, the top-K and the contrast factor bit for bit), and times both; the
   top-K prints its planes by path, the contrast factor its frames by path
   and its share of two byte bounds (one read of the interior planes, the
   least any design moves, and two, its own design's).
   Kernels 3 and 6 (one CUDA kernel) also print their block shape,
   resident blocks per SM, shared memory and registers.  A
   kernel's `ms` is the device time of its __global__ functions under
   torch.profiler (mean of 3 calls; kernel 4: CUDA events over 50
   back-to-back calls, as the profiler missed some of its launches); the CUDA
   event time around its wrapper, host work included, is `wrapper_ms`
   (kernel 7 is also timed beside one advanced-indexing call that cuts the
   same patches).  Kernel 2 prints the launch plan of every level
   (kernels/fed.py level_plan, which kernel 5 follows too) and the byte
   floor of a level-at-a-time design; a line before the kernels line gives
   the __global__ launches and device time of kernel 2 per batch and of
   kernel 5 per VGA frame.  Kernel 4 also runs over a pair table (every
   pair of the batch's first 16 frames as one set of views), which must
   equal its plain twin over the same table and the kernel over the
   gathered copies bit for bit in one launch, and `match` over that table
   must be one launch per call and equal its plain twin.
3. Drives the main path through its public entry points at full width:
   extract_batch on batch x 640x480 frames with the default AkazeConfig,
   then consecutive-pair match with the default MatchConfig; 1 warm-up and
   `reps` timed passes on distinct inputs.  Launch counts are zeroed just
   before and read just after; every kernel must have launched.
   One more call runs with utils.profiling.record_spans on: the device ms
   of each frontend.* and matching.* span (upload, scale space, contrast
   factor, candidates, detect, describe, kernel 4, filters).
   One more batch runs under torch.profiler: device time by kernel, split
   into the kernels of akaze_tpu_torch/csrc and PyTorch ops, and the
   device's idle share of that profiled batch.
   Then path A, the same with AkazeConfig(describe_backend="xla") (the
   chunked describe through kernel 7), timed the same way, and path B,
   extract_fn on single VGA frames (kernels 1, 5 and 7), then
   describe(backend="pallas") (kernel 6) on the same frames, each with its
   own launch counts; path A's describe span is printed beside the main
   path's, and one path-B frame runs under torch.profiler.
4. Runs the three paths at a small size through the kernels and through
   the plain twins, both on the card, and holds them to the slice gates
   (paths A and B: equal keypoints and descriptors).
5. Video (BASELINE config 4): process_video on 500 VGA frames uploaded
   once, batch 16, default configs; 1 warm-up, 1 timed call between device
   syncs (frames/s, keyframes, keypoints and matches, launches of kernels
   1-4 counted from zero), then the split by CUDA events (extract,
   consecutive match, keyframe loop; the loop under
   torch.cuda.set_sync_debug_mode("error"), so a host sync in it fails the
   run), then the first 24 frames through the kernels and through the
   twins, which must be exactly equal.
6. Two-view (BASELINE config 2): P = 32 VGA pairs per rep (frame sets of
   video_sequence seeds 1-3, uploaded once), extract_batch + batched match
   + batched estimate_relative_pose with RansacConfig(num_iterations=256);
   1 warm-up and 4 timed reps (pairs/s, split by CUDA events), one RANSAC
   call under torch.profiler (device launches, torch.linalg time); then
   multi_plane_pair seeds 5-8 at 240x320 with RansacConfig(512, 2e-3)
   against the reference bound (rotation <= 1.5 deg, t-direction <= 6 deg,
   >= 30 inliers), and seed 6's card pose against the CPU pose on the same
   correspondences and random scores.
6b. Photogrammetry stills at the sizes of the strecha_dslr cell: one
   3072x2048 frame (benchmark/scenes/textured_pan.py) through extract_batch
   with 8,192 keypoints and 2,048 candidates per level, one launch each of
   kernels 1 and 3 and the NMS kernel and one kernel-2 launch per octave,
   bit-equal to extract_batch_fn(plain=True) (the NMS kernel's multi-window
   path on real candidates); then all 435 pairs of 30 views of 8,192
   synthetic slots through one pair table: match_reduce and match each one
   kernel-4 launch, equal to their plain twins over the same table on 10
   rows drawn from a fixed seed and on (0, 1), (0, 15) and the last pair,
   and kernel 4's time by CUDA events beside its operation bound; then the
   per-level top-K kernel on the score fields of 30 such views against its
   plain form, bit for bit, timed beside its byte bound, its planes by path
   printed, and the contrast factor on the same views' modg planes, as in
   phase 2.

7. SfM (BASELINE config 5): run_incremental on sfm_scene(50, 600, seed 0,
   noise 5e-4) with SfmConfig(ba_iterations=8), RansacConfig(256, 5e-3),
   ba_every=8: 1 warm-up and 1 timed run between device syncs (keyframes/s,
   ATE < 0.05), then the same on the card and on the CPU on the same draws
   (same valid points, camera centers within 2e-3).  Then the 200-keyframe
   loop scene (sfm_scene(200, 5000, loop=True, noise 2e-3) with its
   closures: CG, pose graph, BA re-polish) twice, bit-equal poses and
   points, ATE < 0.05, the second run timed with the package's CUDA-event
   spans on (windows, BA, pose graph, torch.linalg;
   utils.profiling.record_spans) and the host syncs counted by line
   (set_sync_debug_mode("warn")); a third run on JAX's draws
   (interop.jax_uniform), ATE < 0.05, with its middle window under
   torch.profiler (launches, idle share).
   Last the sfm CLI on 64 VGA frames panning out and back (batch 16, loop
   closure on): its stages' spans, kernels 1-4 launched, kernel 4's
   launches in the closure step.
8. The parallel paths (akaze_tpu_torch/parallel, bundle_adjust_sharded,
   run_incremental(mesh=), sfm --mesh), in rank processes that share the
   card: this script started again with hidden --jobs arguments, one
   process per rank, joined by the backend parallel.distributed picks
   (gloo where ranks share a card, as NCCL refuses that).  2 ranks: the DP
   extract of 128 VGA frames (1 warm-up, 3 passes timed by CUDA events in
   each rank, launches counted per rank; the gathered features must equal
   extract_batch's on one rank bit for bit), the row-sharded FED of one VGA
   octave-0 level (bit-equal to fed_cycle; 4 ranks too), BASELINE config 5
   through run_incremental(mesh=) twice (bit-equal runs, ATE < 0.05 and
   within 1e-4 of phase 7's, the same valid points, camera centers within
   1e-2: a float32 reordering of one rank moves them 8.9e-3), the
   K = 200 bundle adjustment phase 7 kept, sharded (bit-equal to the same
   partial sums added in one process, poses within 5e-3 of the single-rank
   BA) and
   the 200-keyframe loop scene end to end (ATE and keyframes/s printed,
   not gated).  3 and 6 ranks: the extract | match | pose pipeline on 24 VGA
   frames, microbatch 4, on JAX's per-frame draws (match counts equal to
   the sequential single-rank path, pose inliers within 2).  Last the sfm
   CLI with --mesh 2 under torch.distributed.run on phase 7's 64 frames
   (the same tracks, points and closures as phase 7's --mesh 0 run, finite
   poses; the camera centers' distance to that run is printed: the scene is
   one textured plane, so float32 reordering alone moves them).  The times are those of ranks sharing one card:
   no scaling number comes from them.
9. Oracles and conductivity variants (BASELINE config 3): prints the host
   CPU and g++, builds akaze_tpu_torch/native (a failed build fails the
   run).  extract_batch on batch 64 of VGA video_sequence frames (seeds
   0-2) with Diffusivity.PM_G1 and WEICKERT, 1 warm-up and 3 timed passes
   (CUDA events, frames/s, launches counted from zero: kernels 1-3 must
   launch); on one batch of each, kernel 2 bit for bit against
   fused_octave_plain, and on one VGA frame extract_fn (kernels 1, 5, 7)
   equal to the plain path and kernel 5 bit for bit level by level.  The
   native single-core C++ pipeline (bench_pipeline_native on
   video_sequence(2, 480, 640, seed=1), reps 3) for pm_g2, pm_g1 and
   weickert, with the card's frames/s over it.  Every SCENE_CLASSES scene
   at the golden scene snapshot's shape and seed through extract on the
   card, held to tests/test_scene_regression.py's gates; the golden NumPy
   copy on this machine's NumPy equal to tests/data/golden_snapshot.npz on
   its stored image (tests/torch_data).  On textured_scene(480, 640,
   seed=0) the card against extract_native for the three diffusivities
   (card -> native >= 90 % within 0.5 px, median <= 4 bits), and kernel 4's
   matcher against the native matcher on a VGA pair (the same accepted
   pairs, the same distances).
10. Degenerate inputs and the benchmark entry point.  a: the cases of
   tests/test_degenerate_inputs.py (a constant image, a 38x36 frame, the
   1241x376 KITTI shape, a uint8 frame, a NaN block; images stored in
   tests/torch_data/degenerate_images.npz) through extract_batch and match
   (kernels 1-4) and through the plain twins on the card, equal slot for
   slot, with the keypoint counts the JAX package finds on the CPU; empty
   descriptor sets into match in three orders (0 matches); kernel 2 on a
   seed with a NaN block, equal to its twin NaN for NaN.  b: two-view
   RANSAC on correspondences with NaN rows on the card against the CPU on
   JAX's draws (the same inliers, R within 0.05 deg, t within 0.2 deg).
   c: `bench_cuda.py --only headline,two_view` as a subprocess; every line
   must carry a finite positive value, and the baseline must be the native
   one where g++ is present.

Prints a JSON line of the sequence, two-view and stills numbers, one of the SfM
numbers, one of the parallel paths' numbers, one of phase 9's, one of
phase 10's, a JSON line of per-kernel numbers (with each kernel's launches
on phase 8's paths, all ranks, on phase 9's and on phase 10a's), the card
line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
GPU is present, when the package is missing, or when any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
# 32-bit popcount: 16 per clock per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 132 SMs at the
# published 1.98 GHz boost clock.
POPC_OPS_PER_S = 16 * 132 * 1.98e9
INT8_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense, published
# The SfM stack's utils.profiling.span names.
SPAN_NAMES = ("sfm.window", "sfm.ba", "sfm.pose_graph", "linalg")
# The spans of extract_batch (frontend.*) and match (matching.*) below their
# entry spans, in the order they open.
STAGE_SPANS = ("frontend.upload", "frontend.scale_space", "frontend.contrast", "frontend.candidates",
               "frontend.detect", "frontend.describe", "matching.reduce", "matching.filter")
# The names of every utils.profiling.span: the profiler projects them onto
# the device's timeline, where they are no device work.
SPAN_PREFIXES = ("sfm.", "linalg", "frontend.", "matching.", "geometry.")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    lines = [l for l in out.stdout.splitlines() if "release" in l]
    return lines[0].strip() if lines else "unknown"


def timed(torch, fn, reps: int = 3):
    """Median CUDA-event time (ms) around fn() over reps runs, after one
    warm-up: device time plus whatever host work holds the stream."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def back_to_back_ms(torch, fn, n: int = 50) -> float:
    """CUDA-event time (ms) of n back-to-back fn() calls, divided by n, after
    a warm-up: the device time per call where the host enqueues faster than
    the card runs it."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def topk_check(torch, stacks, ss, what: str) -> dict:
    """The per-level top-K kernel against its plain form on per-octave score
    stacks, all five leaves bit for bit, one launch; its planes by path,
    bytes (every score read, 17 B written per slot) and time per call
    (CUDA events, 10 back-to-back)."""
    from akaze_tpu_torch.kernels import _build, topk

    before = _build.launches["topk"]
    got = topk.per_level_topk(stacks, ss)
    torch.cuda.synchronize()
    if _build.launches["topk"] != before + 1:
        fail(f"{what}: per_level_topk launched {_build.launches['topk'] - before} times, expected 1")
    paths = topk.path_counts()
    ref = topk.per_level_topk_plain(stacks, ss)
    differ = [k for k in got if not torch.equal(got[k].view(torch.int32) if k == "resp" else got[k],
                                                 ref[k].view(torch.int32) if k == "resp" else ref[k])]
    if differ:
        fail(f"{what}: per_level_topk differs from its plain form in {differ} (bit-equality required)")
    B, L, K = got["resp"].shape
    nbytes = sum(4 * s.numel() for s in stacks) + 17 * B * L * K
    ms = back_to_back_ms(torch, lambda: topk.per_level_topk(stacks, ss), n=10)
    t, _ = bound_ms(nbytes, 0)
    per_plane = torch.cat([(s > -1e38).reshape(s.shape[0] * s.shape[1], -1).sum(-1) for s in stacks]).double()
    print(f"per_level_topk {what}: five leaves bit-equal to the plain form; planes by path {paths}; entries above "
          f"NEG per plane mean {per_plane.mean().item():.1f}, max {int(per_plane.max())} (K = {K}); "
          f"{ms:.4f} ms per call (CUDA events, 10 back-to-back), byte bound {t:.4f} ms "
          f"({nbytes / 1e9:.3f} GB, {100 * t / ms:.1f} % reached)", flush=True)
    if paths["general"] != 0:
        fail(f"{what}: {paths['general']} planes took the top-K's general path on real candidates")
    return {"paths": paths, "ms": ms, "bound_ms": t, "bytes": nbytes}


CONTRAST_KERNELS = ("contrast_max_kernel", "contrast_hist_kernel")


def contrast_check(torch, modg, config, what: str) -> dict:
    """The contrast factor against its plain form on (B, H, W) modg planes,
    k bit for bit, one launch; its frames by path, its device time under the
    profiler, whole and per __global__ function (mean of 3 calls), and its
    time per call (CUDA events, 10 back-to-back), beside two byte bounds:
    one read of the interior planes, the least any design moves, and two,
    the kernel's design (a read for the maximum, one for the bins).  Where
    the profiler missed a launch, `ms` is the events' time."""
    from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
    from akaze_tpu_torch.kernels import _build, contrast

    before = _build.launches["contrast"]
    k = contrast.contrast_factor(modg, config)
    torch.cuda.synchronize()
    if _build.launches["contrast"] != before + 1:
        fail(f"{what}: contrast_factor launched {_build.launches['contrast'] - before} times, expected 1")
    paths = contrast.path_counts()
    if not torch.equal(k.view(torch.int32), contrast_factor_from_modg(modg, config).view(torch.int32)):
        fail(f"{what}: contrast_factor differs from its plain form (bit-equality required)")
    B, H, W = modg.shape
    one_read = 4 * B * (H - 2) * (W - 2)
    reps = 3
    _, rows = profiled(torch, lambda: [contrast.contrast_factor(modg, config) for _ in range(reps)])
    seen = {kernel_name(name): (t / reps, c) for t, c, name in rows if kernel_name(name) in CONTRAST_KERNELS}
    events_ms = back_to_back_ms(torch, lambda: contrast.contrast_factor(modg, config), n=10)
    whole = len(seen) == len(CONTRAST_KERNELS) and all(c == reps for _, c in seen.values())
    ms = sum(t for t, _ in seen.values()) if whole else events_ms
    per = ", ".join(f"{name} {t:.4f} ms in {c} of {reps} launches" for name, (t, c) in seen.items())
    t1, _ = bound_ms(one_read, 0)
    t2, _ = bound_ms(2 * one_read, 0)
    print(f"contrast_factor {what}: k bit-equal to the plain form; frames by path {paths}; profiler: {per}; "
          f"{events_ms:.4f} ms per call (CUDA events, 10 back-to-back); {ms:.4f} ms "
          f"({'device' if whole else 'events: the profiler missed launches'}) against the byte bound of one read "
          f"{t1:.4f} ms ({100 * t1 / ms:.1f} % reached) and of two reads {t2:.4f} ms ({100 * t2 / ms:.1f} % "
          f"reached)", flush=True)
    return {"paths": paths, "ms": ms, "device": whole, "per_launch_ms": {name: t for name, (t, _) in seen.items()},
            "global_launches": sum(c for _, c in seen.values()) / reps, "events_ms": events_ms, "one_read_ms": t1,
            "two_read_ms": t2}


def bound_ms(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs(feats):
    """Consecutive-pair match arguments of a batch of Features."""
    d, v = feats.descriptors, feats.keypoints.valid
    return d[:-1], v[:-1], d[1:], v[1:]


def csrc_kernels(root: Path) -> set:
    """Names of the __global__ functions of akaze_tpu_torch/csrc."""
    ours = set()
    for src in sorted((root / "akaze_tpu_torch" / "csrc").glob("*.cu")):
        ours.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                               src.read_text()))
    return ours


def kernel_name(event_name: str) -> str:
    """The function name of a profiler kernel row: "void f<256>(float
    const*, ...)" and "f(float const*, ...)" both give "f"."""
    return re.sub(r"^void\s+", "", event_name).split("(")[0].split("<")[0]


def profiled(torch, step):
    """Run step() under torch.profiler: (wall ms, [(device ms, calls,
    kernel name)] largest first).  Device-side events only: the aten
    operator rows carry the same time again."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, device_rows(torch, prof)


def device_rows(torch, prof) -> list:
    """[(device ms, calls, kernel name)] of a finished profile, largest
    first; device-side events only (the aten operator rows carry the same
    time again), without the ranges of record_function and of the
    profiler's steps projected onto the device's timeline."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.key.startswith(("ProfilerStep", *SPAN_PREFIXES)):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def kernel_device_ms(torch, ours: set, fn, reps: int = 3):
    """Device time (ms) and __global__ launches of the csrc kernels that one
    fn() runs: their sums under the profiler over reps calls (after one
    warm-up), divided by reps."""
    fn()
    _, rows = profiled(torch, lambda: [fn() for _ in range(reps)])
    mine = [(ms, n) for ms, n, name in rows if kernel_name(name) in ours]
    t = sum(ms for ms, _ in mine) / reps
    if not t > 0:
        fail("the profiler saw no device time in the csrc kernels")
    return t, sum(n for _, n in mine) / reps


def launch_times(torch, ours: set, fn) -> list:
    """(kernel name, device us) of each csrc __global__ launch of one fn()
    (after one warm-up), in launch order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA and kernel_name(e.name) in ours]
    evs.sort(key=lambda e: e.time_range.start)
    return [(kernel_name(e.name), e.time_range.elapsed_us()) for e in evs]


def profile_step(torch, ours: set, what: str, step) -> None:
    """Run step() once under torch.profiler and print its device time by
    kernel: the __global__ functions of akaze_tpu_torch/csrc against
    PyTorch's ops, and the idle share of the profiled step."""
    wall_ms, rows = profiled(torch, step)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        print(f"profiled {what}: wall {wall_ms:.3f} ms, device time not measured (the profiler saw none)",
              flush=True)
        return
    mine = sum(t for t, _, name in rows if kernel_name(name) in ours)
    print(f"profiled {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (under the profiler); {mine:.3f} ms in the "
          f"{len(ours)} kernels of akaze_tpu_torch/csrc, {busy_ms - mine:.3f} ms in PyTorch ops",
          flush=True)
    for t, n, name in rows[:20]:
        print(f"  {t:10.3f} ms {n:6d} calls  {name[:100]}", flush=True)


def mangled_name(m: str) -> str:
    """A kernel's name from its mangled symbol: "_Z17base_stage_kernelILi9EEv..."
    gives "base_stage_kernel<9>"."""
    head = re.match(r"_Z(\d+)", m)
    if not head:
        return m
    n = int(head.group(1))
    name, rest = m[head.end() : head.end() + n], m[head.end() + n :]
    if rest.startswith("I"):
        name += "<" + ",".join(re.findall(r"Li(\d+)E", rest.split("EE")[0] + "E")) + ">"
    return name


def ptxas_report(logs: dict) -> list:
    """(source, kernel, registers, spill store bytes, spill load bytes) of
    every __global__ function in nvcc's -Xptxas=-v output."""
    out = []
    for src, log in sorted(logs.items()):
        name, spills = None, (0, 0)
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                name, spills = mangled_name(m.group(1)), (0, 0)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                out.append((src, name, int(m.group(1)), *spills))
                name = None
    return out


def hamming(np, a, b):
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)


def rot_deg(np, Ra, Rb) -> float:
    """Angle of the rotation between two (3, 3) rotations, in degrees."""
    Ra, Rb = np.asarray(Ra, np.float64), np.asarray(Rb, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def dir_deg(np, ta, tb, signed: bool = True) -> float:
    """Angle between two directions in degrees; signed=False is the
    reference bound's sign-blind t-direction error."""
    ta, tb = np.asarray(ta, np.float64), np.asarray(tb, np.float64)
    c = ta @ tb / (np.linalg.norm(ta) * np.linalg.norm(tb))
    return float(np.degrees(np.arccos(np.clip(c if signed else abs(c), -1, 1))))


def phase_video(torch, np, dev, reset_counts, out: dict) -> None:
    """Phase 5: the video front end at full width (see the module doc)."""
    from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, SfmConfig
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.matching.video import (
        consecutive_matches, extract_frames, process_video, process_video_fn, select_keyframes,
    )
    from akaze_tpu_torch.utils.synthetic import video_sequence

    T, H, W, batch = 500, 480, 640, 16
    print(f"\n== video: process_video on {T} frames of {W}x{H}, batch {batch}", flush=True)
    t0 = time.perf_counter()
    frames = torch.from_numpy(video_sequence(T, H, W, seed=0)).to(dev)
    torch.cuda.synchronize()
    print(f"frames made and uploaded in {time.perf_counter() - t0:.1f} s "
          f"({frames.numel() * 4 / 1e6:.0f} MB on the card)", flush=True)
    config, mcfg, scfg = AkazeConfig(), MatchConfig(max_distance=120), SfmConfig()
    t0 = time.perf_counter()
    process_video(frames, config, batch=batch, device=dev)
    torch.cuda.synchronize()
    print(f"warm-up call {time.perf_counter() - t0:.3f} s", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    res = process_video(frames, config, batch=batch, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    kp = res.features.keypoints
    kp_mean = kp.count().double().mean().item()
    if not (torch.isfinite(kp.x[kp.valid]).all() and kp_mean > 0):
        fail("video: no or non-finite keypoints")
    if res.features.descriptors.shape != (T, config.max_keypoints, 16) or res.keyframes[0] != 0:
        fail("video: unexpected output shapes or keyframes")
    chunks = -(-T // batch)
    expect = {"base_stage": chunks, "fused_octave": 4 * chunks, "describe": chunks, "match": 1 + (T - 1),
              "nms": chunks, "topk": chunks, "contrast": chunks}
    print(f"timed call {wall:.3f} s: {T / wall:.1f} frames/s; {len(res.keyframes)} keyframes; keypoints/frame "
          f"mean {kp_mean:.1f}; accepted matches/pair mean {res.match_counts[1:].mean():.1f}; matches to the "
          f"keyframe mean {res.kf_match_counts[1:].mean():.1f}", flush=True)
    print(f"kernels launched by the timed call: {counts}", flush=True)
    for name, n in expect.items():
        if counts[name] != n:
            fail(f"video: kernel {name} launched {counts[name]} times, expected {n}")

    # The split, each stage called as process_video calls it.
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    feats = extract_frames(frames, config, batch)
    ev[1].record()
    matches = consecutive_matches(feats, mcfg)
    ev[2].record()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")  # a host sync in the loop raises
    try:
        kf_counts, is_kf = select_keyframes(feats, mcfg, scfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host_loop = time.perf_counter() - t0
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    print(f"split (CUDA events): extract {split[0]:.3f} ms, consecutive match {split[1]:.3f} ms, keyframe loop "
          f"{split[2]:.3f} ms ({T - 1} matches; host issued it in {host_loop * 1e3:.3f} ms, no host sync)",
          flush=True)
    if not (np.array_equal(kf_counts.cpu().numpy(), res.kf_match_counts)
            and np.array_equal(matches.count().cpu().numpy(), res.match_counts)):
        fail("video: the split run differs from the timed call")

    # The first 24 frames through the kernels and through the plain twins.
    sub = frames[:24]
    got = process_video_fn(sub, config, mcfg, scfg, batch=batch)
    ref = process_video_fn(sub, config, mcfg, scfg, batch=batch, plain=True)
    same = (got.keyframes == ref.keyframes and np.array_equal(got.match_counts, ref.match_counts)
            and np.array_equal(got.kf_match_counts, ref.kf_match_counts)
            and all(torch.equal(getattr(got.matches_prev, k), getattr(ref.matches_prev, k))
                    for k in ("idx_b", "distance", "accepted")))
    print(f"24 frames (chunks 16 + 8), kernels vs plain twins: keyframes {got.keyframes} / {ref.keyframes}, "
          f"match counts, keyframe counts and matches {'exactly equal' if same else 'DIFFERENT'}", flush=True)
    if not same:
        fail("video through the kernels differs from the plain twins")
    out["video"] = {
        "frames": T, "batch": batch, "fps": T / wall, "wall_s": wall, "keyframes": len(res.keyframes),
        "keypoints_per_frame": kp_mean, "matches_per_pair": float(res.match_counts[1:].mean()),
        "extract_ms": split[0], "match_ms": split[1], "keyframe_loop_ms": split[2],
        "keyframe_loop_host_ms": host_loop * 1e3, "launches": counts,
    }


def phase_two_view(torch, np, dev, reset_counts, out: dict) -> None:
    """Phase 6: two-view pose at full width and against the reference bound
    (see the module doc)."""
    from torch.profiler import ProfilerActivity, profile

    from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, RansacConfig
    from akaze_tpu_torch.frontend.pipeline import extract_batch
    from akaze_tpu_torch.geometry.twoview import estimate_relative_pose, estimate_relative_pose_fn, normalize_points
    from akaze_tpu_torch.interop import jax_uniform
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.matching.hamming import match, match_features
    from akaze_tpu_torch.utils.synthetic import multi_plane_pair, video_sequence

    P, H, W = 32, 480, 640
    intr = (640.0, 640.0, 320.0, 240.0)
    config, mcfg, rcfg = AkazeConfig(), MatchConfig(), RansacConfig(num_iterations=256)
    print(f"\n== two-view: {P} VGA pairs per rep, extract + match + RANSAC "
          f"(num_iterations {rcfg.num_iterations}, beam {rcfg.refit_beam})", flush=True)
    frame_sets = [torch.from_numpy(video_sequence(2 * P, H, W, seed=s)).to(dev) for s in (1, 2, 3)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(rcfg.seed)

    def pose_of(feats, m):
        kp, idx = feats.keypoints, m.idx_b.long()
        x1 = normalize_points(kp.x[0::2], kp.y[0::2], intr)
        x2 = normalize_points(torch.gather(kp.x[1::2], 1, idx), torch.gather(kp.y[1::2], 1, idx), intr)
        return (x1, x2, m.accepted), estimate_relative_pose(x1, x2, m.accepted, rcfg, generator=gen, device=dev)

    def rep(frames, ev):
        ev[0].record()
        feats = extract_batch(frames, config, device=dev)
        ev[1].record()
        kp = feats.keypoints
        m = match(feats.descriptors[0::2], kp.valid[0::2], feats.descriptors[1::2], kp.valid[1::2], mcfg, device=dev)
        ev[2].record()
        args, pose = pose_of(feats, m)
        ev[3].record()
        return args, pose

    events = lambda: [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    rep(frame_sets[0], events())  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    reps, splits, inliers = 4, [], []
    t0 = time.perf_counter()
    for r in range(reps):
        splits.append(events())
        args, pose = rep(frame_sets[r % len(frame_sets)], splits[-1])
        inliers.append(pose.num_inliers)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    ms = [[ev[i].elapsed_time(ev[i + 1]) for i in range(3)] for ev in splits]
    inl = torch.stack(inliers).cpu()
    print(f"{reps} reps in {wall:.3f} s: {P * reps / wall:.1f} pairs/s; per rep (CUDA events) extract "
          f"{[round(x[0], 3) for x in ms]} ms, match {[round(x[1], 3) for x in ms]} ms, RANSAC "
          f"{[round(x[2], 3) for x in ms]} ms", flush=True)
    print(f"inliers per pair: mean {inl.double().mean().item():.1f}, min {int(inl.min())}; kernels launched by "
          f"the timed reps: {counts}", flush=True)
    for name in ("base_stage", "fused_octave", "describe", "match"):
        if counts[name] <= 0:
            fail(f"two-view: kernel {name} was not launched")
    if inl.min() <= 0 or len({int(x.sum()) for x in inl}) < 2:
        fail("two-view: a pair without inliers, or distinct inputs gave identical inlier counts")

    # One RANSAC call under the profiler: device launches and torch.linalg.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        estimate_relative_pose(*args, rcfg, generator=gen, device=dev)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    dev_rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in dev_rows) / 1e3
    n_launch = sum(e.count for e in dev_rows)
    print(f"RANSAC under the profiler: wall {prof_wall:.3f} ms, device busy {dev_ms:.3f} ms in {n_launch} device "
          f"launches (kernels, copies, fills); largest:", flush=True)
    for e in sorted(dev_rows, key=lambda e: -getattr(e, "self_device_time_total", 0.0))[:8]:
        print(f"  {getattr(e, 'self_device_time_total', 0.0) / 1e3:10.3f} ms {e.count:6d} calls  {e.key[:90]}",
              flush=True)
    # torch.linalg at one RANSAC call's shapes, by CUDA events (median of 3):
    # 3 refit rounds of QR (P, M, N, 9) -> R, SVD of R (9x9) and of e (3x3);
    # _recover_pose's SVD of E (3x3) and 2 determinants.
    M, N = min(rcfg.refit_beam, rcfg.num_iterations), args[2].shape[-1]
    aw, r9, e3 = (torch.rand(s, device=dev) for s in ((P, M, N, 9), (P, M, 9, 9), (P, M, 3, 3)))
    lin = {"qr": timed(torch, lambda: torch.linalg.qr(aw, mode="r")),
           "svd9": timed(torch, lambda: torch.linalg.svd(r9)),
           "svd3": timed(torch, lambda: torch.linalg.svd(e3)),
           "det3": timed(torch, lambda: torch.linalg.det(e3))}
    lin_ms = 3 * lin["qr"] + 3 * lin["svd9"] + 4 * lin["svd3"] + 2 * lin["det3"]
    print(f"torch.linalg per RANSAC call ({P} pairs x beam {M}, N {N}): {lin_ms:.3f} ms of "
          f"{sum(x[2] for x in ms) / reps:.3f} (3 x qr {lin['qr']:.3f}, 3 x svd 9x9 {lin['svd9']:.3f}, "
          f"4 x svd 3x3 {lin['svd3']:.3f}, 2 x det {lin['det3']:.3f} ms)", flush=True)
    del frame_sets, args
    torch.cuda.empty_cache()

    # Accuracy against the reference bound, and the card against the CPU.
    # The bound was set on tests/test_two_view_bound.py's random scores,
    # jax.random.uniform(PRNGKey(0)), reproduced here by interop.jax_uniform;
    # the port's own generator gives other draws, whose errors are printed
    # beside (other draws miss the bound on some scenes in the reference
    # too: tools/twoview_draw_sweep.py).
    print("\n== two-view accuracy: multi_plane_pair seeds 5-8 (240x320), RansacConfig(512, 2e-3)", flush=True)
    acfg = RansacConfig(num_iterations=512, inlier_threshold=2e-3)
    errors = {}
    for seed in (5, 6, 7, 8):
        img_a, img_b, R_gt, t_gt, intr2 = multi_plane_pair(seed=seed)
        feats = extract_batch(np.stack([img_a, img_b]), config, device=dev)
        mm = match_features(feats.index(0), feats.index(1), mcfg, device=dev)
        kp, idx = feats.keypoints, mm.idx_b.long()
        x1 = normalize_points(kp.x[0], kp.y[0], intr2)
        x2 = normalize_points(kp.x[1][idx], kp.y[1][idx], intr2)
        shape = (acfg.num_iterations, x1.shape[0])
        ref_draws = torch.from_numpy(jax_uniform(acfg.seed, shape)).to(dev)
        own_draws = torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(acfg.seed), device=dev)
        card = estimate_relative_pose_fn(x1, x2, mm.accepted, acfg, sample_scores=ref_draws)
        own = estimate_relative_pose_fn(x1, x2, mm.accepted, acfg, sample_scores=own_draws)
        rot, tdir = rot_deg(np, card.R.cpu().numpy(), R_gt), dir_deg(np, card.t.cpu().numpy(), t_gt, signed=False)
        own_rot, own_tdir = rot_deg(np, own.R.cpu().numpy(), R_gt), dir_deg(np, own.t.cpu().numpy(), t_gt, signed=False)
        n_in = int(card.num_inliers)
        print(f"seed {seed}: {int(mm.count())} matches; the reference test's draws: {n_in} inliers, rotation error "
              f"{rot:.4f} deg, t-direction error {tdir:.4f} deg (bound 1.5 / 6); the port's own generator (seed "
              f"{acfg.seed}): {int(own.num_inliers)} inliers, {own_rot:.4f} / {own_tdir:.4f} deg", flush=True)
        errors[seed] = {"rot_deg": rot, "tdir_deg": tdir, "inliers": n_in, "own_generator": {
            "rot_deg": own_rot, "tdir_deg": own_tdir, "inliers": int(own.num_inliers)}}
        if not (rot <= 1.5 and tdir <= 6.0 and n_in >= 30):
            fail(f"two-view seed {seed}: outside the reference bound or under 30 inliers")
        if seed == 6:
            cpu = estimate_relative_pose_fn(x1.cpu(), x2.cpu(), mm.accepted.cpu(), acfg, sample_scores=own_draws.cpu())
            d_rot = rot_deg(np, own.R.cpu().numpy(), cpu.R.numpy())
            d_t = dir_deg(np, own.t.cpu().numpy(), cpu.t.numpy())
            n_own, n_cpu = int(own.num_inliers), int(cpu.num_inliers)
            print(f"seed 6, card against the CPU on the same correspondences and the own generator's scores: R "
                  f"{d_rot:.5f} deg, t-direction {d_t:.5f} deg, inliers {n_own} / {n_cpu}", flush=True)
            if not (d_rot <= 0.05 and d_t <= 0.2 and abs(n_own - n_cpu) <= max(1, 0.01 * n_cpu)):
                fail("two-view: the card's pose differs from the CPU's beyond R 0.05 / t 0.2 deg / inliers 1 %")
            errors["card_vs_cpu"] = {"rot_deg": d_rot, "tdir_deg": d_t, "inliers": [n_own, n_cpu]}
    out["two_view"] = {
        "pairs": P, "reps": reps, "pairs_per_s": P * reps / wall, "wall_s": wall,
        "extract_ms": [x[0] for x in ms], "match_ms": [x[1] for x in ms], "ransac_ms": [x[2] for x in ms],
        "ransac_profiled": {"wall_ms": prof_wall, "device_ms": dev_ms, "device_launches": n_launch},
        "linalg_ms": lin_ms, "linalg_calls_ms": lin,
        "launches": counts, "accuracy": errors,
    }


def stills_descriptors(torch, n: int, k: int, dev, seed: int):
    """n views of k descriptors (16 int32 words, 486 bits), each a shuffled
    copy of one pool of k rows with each bit flipped with chance 40 / 486,
    so that every pair shares correspondences; 85 % of the slots valid and
    view 1 with none."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pool = torch.randint(0, 2**32, (k, 16), generator=gen, device=dev, dtype=torch.int64)
    flips = (torch.rand((n, k, 16, 32), generator=gen, device=dev) < 40 / 486).long()
    flips = (flips << torch.arange(32, device=dev)).sum(-1)
    desc = torch.stack([pool[torch.randperm(k, generator=gen, device=dev)] for _ in range(n)]) ^ flips
    desc[..., -1] &= (1 << 6) - 1
    desc = torch.where(desc >= 2**31, desc - 2**32, desc).to(torch.int32).contiguous()
    valid = torch.rand((n, k), generator=gen, device=dev) < 0.85
    valid[1] = False
    return desc, valid


def phase_stills(torch, np, dev, reset_counts, out: dict) -> None:
    """Phase 6b: the photogrammetry stills of strecha_dslr at their own
    sizes (see the module doc)."""
    from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig
    from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.kernels.fed import base_stage, build_scale_space
    from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain, pair_table
    from akaze_tpu_torch.matching.hamming import match, match_fn
    from benchmark.scenes.textured_pan import textured_scene

    H, W, N, K = 2048, 3072, 30, 8192
    config, mcfg = AkazeConfig(max_keypoints=K, per_level_candidates=2048), MatchConfig()
    pair_list = [(i, j) for i in range(N) for j in range(i + 1, N)]
    P = len(pair_list)
    print(f"\n== stills: one {W}x{H} frame at {K} keypoints / {config.per_level_candidates} candidates per level, "
          f"then all {P} pairs of {N} views of {K} slots through one pair table", flush=True)
    t_phase = time.perf_counter()

    # One frame through the kernels against the same frame through the twins.
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    frame = torch.round(textured_scene(H, W, gen, dev) * 255.0).to(torch.uint8)[None]
    extract_batch(frame, config, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fk = extract_batch(frame, config, device=dev)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    launched = dict(counts)  # over the phase's checked calls
    want = {"base_stage": 1, "fused_octave": 4, "nms": 1, "topk": 1, "describe": 1, "contrast": 1}
    if any(counts.get(name) != n for name, n in want.items()):
        fail(f"stills: extract_batch of one {W}x{H} frame launched {counts}, expected {want}")
    fp = extract_batch_fn(frame, config, plain=True)
    fields = ("x", "y", "response", "size", "octave", "class_id", "angle", "valid")
    differ = [f for f in fields if not torch.equal(getattr(fk.keypoints, f), getattr(fp.keypoints, f))]
    differ += [] if torch.equal(fk.descriptors, fp.descriptors) else ["descriptors"]
    n_valid = int(fk.keypoints.valid.sum())
    print(f"extract_batch at {W}x{H}: {n_valid} valid of {K} slots, {extract_s * 1e3:.2f} ms wall, launches "
          f"{counts}; against the plain twins: {'bit-equal' if not differ else 'DIFFERENT in ' + ', '.join(differ)}",
          flush=True)
    if differ:
        fail(f"stills: extract_batch at {W}x{H} differs from the plain twins in {differ} (bit-equality required)")
    del fk, fp, frame
    torch.cuda.empty_cache()

    # The per-level top-K on the score fields of N views, the cell's call.
    ss, _ = _statics(W, H, config)
    views = torch.stack([torch.round(textured_scene(H, W, gen, dev) * 255.0) / 255.0 for _ in range(N)])
    stacks = [f["score"] for f in build_scale_space(views, ss)["oct"]]
    modg = base_stage(views, float(config.base_scale_offset))[1]
    del views
    torch.cuda.empty_cache()
    topk_views = topk_check(torch, stacks, ss, f"{N} views at {W}x{H}")
    launched["topk"] += 1
    del stacks
    torch.cuda.empty_cache()
    contrast_views = contrast_check(torch, modg, config, f"{N} views at {W}x{H}")
    launched["contrast"] += 1
    del modg
    torch.cuda.empty_cache()

    # All pairs of N views of K slots: kernel 4 over the pair table in one
    # launch, against the plain twin over the same table on seeded rows.
    d, v = stills_descriptors(torch, N, K, dev, seed=5)
    host_table = torch.tensor(pair_list, dtype=torch.int32)
    table = pair_table(host_table, N, N, dev)
    rows = sorted({0, pair_list.index((0, N // 2)), P - 1}
                  | set(torch.randperm(P, generator=torch.Generator().manual_seed(20))[:10].tolist()))
    sub = torch.tensor([pair_list[p] for p in rows], dtype=torch.int32)
    at = torch.tensor(rows, device=dev)
    match_reduce(d, v, d, v, table)
    torch.cuda.synchronize()
    reset_counts()
    got = match_reduce(d, v, d, v, table)
    torch.cuda.synchronize()
    if _build.launches["match"] != 1:
        fail(f"stills: match_reduce over {P} pairs launched kernel 4 {_build.launches['match']} times, expected 1")
    launched["match"] = launched.get("match", 0) + 1
    if _build.counts["match_pairs"] != P or _build.counts["match_slot_pairs"] != P * K * K:
        fail(f"stills: pair counters {_build.counts['match_pairs']} / {_build.counts['match_slot_pairs']}, expected "
             f"{P} / {P * K * K}")
    plain = match_reduce_plain(d, v, d, v, sub)
    for name, g, r in zip(("best", "second", "nn", "colmin", "colarg"), got, plain):
        if not torch.equal(g[at], r):
            fail(f"stills: match_reduce over the pair table: {name} differs from its plain twin on rows {rows}")
    reduce_ms = back_to_back_ms(torch, lambda: match_reduce(d, v, d, v, table), n=10)
    # Kernel 4's work as phase 2 counts it, over the table's pairs.
    a, b = table[:, 0].long(), table[:, 1].long()
    n_valid_views = v.sum(1).double()
    na, nb = n_valid_views[a], n_valid_views[b]
    n_dist = float((K * nb + na * K - na * nb).sum().item())
    bound = 1024 * n_dist / INT8_OPS_PER_S * 1e3
    print(f"match_reduce over {P} pairs of {K} slots: one launch, rows {rows} equal to the plain twin; "
          f"{reduce_ms:.3f} ms per call (CUDA events, 10 back-to-back), {n_dist / 1e9:.3f} G distances, operation "
          f"bound {bound:.3f} ms ({100 * bound / reduce_ms:.1f} % reached)", flush=True)

    match(d, v, d, v, mcfg, device=dev, pairs=host_table)
    torch.cuda.synchronize()
    reset_counts()
    m = match(d, v, d, v, mcfg, device=dev, pairs=host_table)
    torch.cuda.synchronize()
    if _build.launches["match"] != 1:
        fail(f"stills: match over {P} pairs launched kernel 4 {_build.launches['match']} times, expected 1")
    launched["match"] += 1
    mp = match_fn(d, v, d, v, mcfg, plain=True, pairs=sub)
    if not all(torch.equal(getattr(m, key)[at], getattr(mp, key)) for key in ("idx_b", "distance", "accepted")):
        fail(f"stills: match over the pair table differs from its plain twin on rows {rows}")
    accepted = int(m.accepted.sum())
    print(f"match over {P} pairs: one launch, {accepted} accepted, rows {rows} equal to the plain twin", flush=True)
    if accepted == 0:
        fail("stills: match over the pair table accepted nothing")
    out["stills"] = {
        "frame": [W, H], "max_keypoints": K, "valid": n_valid, "extract_ms": extract_s * 1e3,
        "views": N, "pairs": P, "match_reduce_ms": reduce_ms, "match_bound_ms": bound, "accepted": accepted,
        "checked_rows": rows, "topk": topk_views, "contrast": contrast_views, "launches": launched,
        "phase_s": time.perf_counter() - t_phase,
    }
    del d, v, got, plain, m, mp
    torch.cuda.empty_cache()
    print(f"phase 6b: {out['stills']['phase_s']:.1f} s", flush=True)


def revisit_frames(np, textured_scene, T: int, H: int, W: int):
    """(T, H, W) crops of one textured scene twice the frame width that pan
    out by 0.9 W and back: keyframes fire on the way, and the return
    revisits the first frames (loop-closure candidates)."""
    base = textured_scene(H, 2 * W, seed=11)
    offs = np.round(W * 0.9 * np.sin(np.pi * np.arange(T) / (T - 1))).astype(int)
    return np.stack([base[:, o : o + W] for o in offs])


def sfm_run_counted(torch, step):
    """Run step() with the SfM stack's CUDA-event spans on
    (`utils.profiling.record_spans`: windows, BA, pose graph, torch.linalg)
    and the host syncs caught under torch.cuda.set_sync_debug_mode("warn"),
    counted by source line and by window (from one `sfm.window` span to the
    next; those before the first are the two-view init's).  Returns (step's
    result, the SpanRecorder, {line: syncs}, syncs before the first window,
    [syncs of each window])."""
    import warnings

    from akaze_tpu_torch.utils.profiling import SpanRecorder, record_spans

    marks = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", UserWarning)
        rec = SpanRecorder(on_enter=lambda name: marks.append(len(caught)) if name == "sfm.window" else None)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with record_spans(rec):
                out = step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    is_sync = ["synchroniz" in str(w.message) for w in caught]
    sites = {}
    for w, sync in zip(caught, is_sync):
        if sync:
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    bounds = marks + [len(caught)]
    per_window = [sum(is_sync[i:j]) for i, j in zip(bounds[:-1], bounds[1:])]
    return out, rec, sites, sum(is_sync[: bounds[0]]), per_window


def phase_sfm(torch, np, dev, reset_counts, out: dict, keep: dict) -> None:
    """Phase 7: incremental SfM (BASELINE config 5 and the 200-keyframe
    loop scene) and the sfm CLI end to end (see the module doc).  Leaves in
    `keep` what phase 8 holds its sharded runs against: the 50-keyframe run
    ("kf50"), one bundle adjustment of the 200-keyframe run's middle window,
    its input and its poses ("k200"), and the CLI's output ("cli")."""
    import contextlib
    import io
    import tempfile

    from akaze_tpu_torch.cli import sfm as cli_sfm
    from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
    from akaze_tpu_torch.interop import ba_problem_to_numpy, jax_uniform
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.sfm import incremental, loop_closure
    from akaze_tpu_torch.sfm.metrics import ate_rmse, camera_centers
    from akaze_tpu_torch.utils.synthetic import sfm_scene, textured_scene

    scfg, rcfg = SfmConfig(ba_iterations=8), RansacConfig(num_iterations=256, inlier_threshold=5e-3)
    res_out = {}

    def run(scene, device, **kw):
        gt, obs, closures = scene
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = incremental.run_incremental(obs, len(gt), scfg, rcfg, ba_every=8, closures=closures or None,
                                          device=device, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return res, wall, ate_rmse(camera_centers(res.poses), camera_centers(gt))

    # BASELINE config 5: 50 keyframes, 600 points; then its CPU twin.
    print("\n== SfM: BASELINE config 5, sfm_scene(50, 600, seed=0, obs_noise=5e-4), SfmConfig(ba_iterations=8), "
          "RansacConfig(256, 5e-3), ba_every=8", flush=True)
    s50 = sfm_scene(50, 600, seed=0, obs_noise=5e-4)
    reset_counts()
    _, warm50, _ = run(s50, dev)
    r50, wall50, ate50 = run(s50, dev)
    launched = {k: v for k, v in _build.launches.items() if v}
    print(f"warm-up {warm50:.3f} s; timed run {wall50:.3f} s: {50 / wall50:.2f} keyframes/s, ATE {ate50:.5f} "
          f"(gate 0.05), {len(r50.track_point)} valid points of {len(r50.points)} rows; CUDA kernels of the port "
          f"launched: {launched or 'none (synthetic tracks, no images)'}", flush=True)
    # The card and its CPU twin on the same random draws (each generator
    # draws its own stream): the two-view init's RANSAC scores from
    # interop.jax_uniform on both.
    g50, _, g_ate = run(s50, dev, draws=jax_uniform)
    c50, cpu_wall, cpu_ate = run(s50, torch.device("cpu"), draws=jax_uniform)
    d_centers = float(np.abs(camera_centers(g50.poses) - camera_centers(c50.poses)).max())
    print(f"card and CPU twin ({torch.get_num_threads()} threads, {cpu_wall:.3f} s) on the same draws: ATE "
          f"{g_ate:.5f} / {cpu_ate:.5f}, valid points {len(g50.track_point)} / {len(c50.track_point)}, camera "
          f"centers max |diff| {d_centers:.3e} scene units (gate 2e-3)", flush=True)
    if not ate50 < 0.05:
        fail(f"SfM 50 kf: ATE {ate50:.4f} >= 0.05")
    # The gate, from the card-vs-CPU readings: 8.2e-4 seen (float32 sums in
    # another order, carried through 7 windows of PnP and BA), gate 2e-3.
    if len(c50.track_point) != len(g50.track_point) or not d_centers < 2e-3:
        fail("SfM 50 kf: the card and the CPU twin disagree (valid points, or camera centers beyond 2e-3)")
    keep["kf50"] = (r50, ate50)
    res_out["kf50"] = {"keyframes": 50, "points": 600, "wall_s": wall50, "keyframes_per_s": 50 / wall50,
                       "ate": ate50, "valid_points": len(r50.track_point), "warmup_s": warm50,
                       "card_vs_cpu_same_draws": {"cpu_wall_s": cpu_wall, "ate": [g_ate, cpu_ate],
                                                  "valid_points": [len(g50.track_point), len(c50.track_point)],
                                                  "centers_max_diff": d_centers}}

    # The 200-keyframe loop scene with its closures: CG past K = 64, the
    # pose graph at the closing window, the BA re-polish.
    print("\n== SfM: sfm_scene(200, 5000, seed=0, loop=True, obs_noise=2e-3) with its 3 closures, same configs",
          flush=True)
    s200 = sfm_scene(200, 5000, seed=0, loop=True, obs_noise=2e-3)
    K200 = len(s200[0])
    # Run 1 keeps the 12th bundle adjustment (a K = 200 problem, the CG
    # solve) for phase 8: its input and its poses.
    real_ba, n_ba = incremental.bundle_adjust, []

    def keep_ba(problem, config):
        result = real_ba(problem, config)
        n_ba.append(1)
        if len(n_ba) == 12:
            keep["k200"] = (ba_problem_to_numpy(problem), result.poses.cpu().numpy(), config)
        return result

    incremental.bundle_adjust = keep_ba
    try:
        ra, wall_a, ate_a = run(s200, dev)
    finally:
        incremental.bundle_adjust = real_ba
    # Run 2, timed, with the package's CUDA-event spans on and the host
    # syncs counted (neither reads anything back during the run).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb, spans, sync_sites, init_syncs, window_syncs = sfm_run_counted(
        torch, lambda: incremental.run_incremental(s200[1], K200, scfg, rcfg, ba_every=8, closures=s200[2],
                                                   device=dev))
    wall_b = time.perf_counter() - t0
    ate_b = ate_rmse(camera_centers(rb.poses), camera_centers(s200[0]))
    same = np.array_equal(ra.poses, rb.poses) and np.array_equal(ra.points, rb.points)
    windows = len(window_syncs)
    ms = {k: spans.ms(k) for k in SPAN_NAMES}
    n_sync = sum(sync_sites.values())
    print(f"run 1 {wall_a:.3f} s (first at these shapes), run 2 {wall_b:.3f} s: {K200 / wall_b:.2f} keyframes/s; "
          f"ATE {ate_a:.5f} / {ate_b:.5f} (gate 0.05); {len(rb.track_point)} valid points of {len(rb.points)} rows; "
          f"runs 1 and 2 {'bit-equal' if same else 'DIFFERENT'} (poses and points)", flush=True)
    print(f"  run 2: {windows} windows, {spans.count('sfm.ba')} bundle adjustments, "
          f"{spans.count('sfm.pose_graph')} pose graph; ms by span (CUDA events on the stream, idle gaps "
          f"included): windows (PnP + triangulation) {ms['sfm.window']:.3f}, BA {ms['sfm.ba']:.3f}, pose graph "
          f"{ms['sfm.pose_graph']:.3f}, torch.linalg (inside those, and the two-view init's) {ms['linalg']:.3f} in "
          f"{spans.count('linalg')} spans", flush=True)
    print(f"  host syncs: {n_sync} in the run: {init_syncs} in the two-view init, then per window min "
          f"{min(window_syncs)} / mean {sum(window_syncs) / windows:.2f} / max {max(window_syncs)} (the last "
          f"window's count includes the final reads); by line: "
          + ", ".join(f"{site} x{n}" for site, n in sorted(sync_sites.items(), key=lambda x: -x[1])), flush=True)
    if not (ate_a < 0.05 and ate_b < 0.05):
        fail(f"SfM 200 kf: ATE {ate_a:.4f} / {ate_b:.4f} >= 0.05")
    if not same:
        fail("SfM 200 kf: two runs on the card differ")
    keep["kf200_ate"] = ate_b

    # Run 3 on JAX's draws (interop.jax_uniform, the draws of the reference
    # run): the ATE gate again, and its middle window under torch.profiler
    # (on_window steps the profiler's schedule; its host read of the poses
    # closes each window).
    from torch.profiler import ProfilerActivity, profile, schedule

    target = -(-(K200 - 1) // 8) // 2
    marks = []

    def on_window(*_):
        marks.append(time.perf_counter())
        prof.step()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=target - 1, warmup=1, active=1, repeat=1)) as prof:
        rj, _, ate_j = run(s200, dev, draws=jax_uniform, on_window=on_window)
    rows = device_rows(torch, prof)
    wall_ms = (marks[target] - marks[target - 1]) * 1e3
    busy = sum(r[0] for r in rows)
    n_launch = sum(r[1] for r in rows)
    print(f"run 3 on JAX's draws: ATE {ate_j:.5f} (gate 0.05), {len(rj.track_point)} valid points; its window "
          f"{target} (to keyframe {min(8 * (target + 1), K200 - 1)}) under torch.profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall_ms if wall_ms else float('nan'):.3f}, "
          f"{n_launch} device launches; largest:", flush=True)
    for t, n, name in rows[:6]:
        print(f"    {t:9.3f} ms {n:6d} calls  {name[:90]}", flush=True)
    if not ate_j < 0.05:
        fail(f"SfM 200 kf on JAX's draws: ATE {ate_j:.4f} >= 0.05")
    if not 0 < busy <= wall_ms:
        fail(f"SfM window profile: device busy {busy:.3f} ms against a wall of {wall_ms:.3f} ms")
    res_out["kf200"] = {
        "keyframes": K200, "points": 5000, "wall_s": wall_b, "first_run_s": wall_a, "keyframes_per_s": K200 / wall_b,
        "ate": ate_b, "ate_jax_draws": ate_j, "valid_points": len(rb.track_point), "bit_equal_runs": same,
        "windows": windows, "span_ms": ms, "linalg_spans": spans.count("linalg"), "host_syncs": n_sync,
        "host_syncs_init": init_syncs, "host_syncs_per_window": window_syncs, "sync_sites": sync_sites,
        "window_profile": {"window": target, "wall_ms": wall_ms, "device_ms": busy,
                           "idle_share": 1 - busy / wall_ms if wall_ms else None, "device_launches": n_launch},
    }
    del spans, prof, rows
    torch.cuda.empty_cache()

    # The sfm CLI end to end on VGA frames (kernels 1-4), loop closure on.
    T, H, W, batch = 64, 480, 640, 16
    print(f"\n== SfM CLI: python -m akaze_tpu_torch.cli.sfm on {T} VGA frames (a pan out and back), batch {batch}",
          flush=True)
    real = loop_closure.detect_loop_closures
    closure_launches = {}

    def counted(*a, **k):
        before = _build.launches["match"]
        result = real(*a, **k)
        closure_launches["match"] = _build.launches["match"] - before
        return result

    with tempfile.TemporaryDirectory() as tmp:
        frames_path, out_path = Path(tmp) / "frames.npy", Path(tmp) / "traj.json"
        np.save(frames_path, revisit_frames(np, textured_scene, T, H, W))
        loop_closure.detect_loop_closures = counted
        log = io.StringIO()
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(log):
                rc_cli = cli_sfm.main([str(frames_path), "-o", str(out_path), "--batch", str(batch),
                                       "--device", str(dev)])
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t0
        finally:
            loop_closure.detect_loop_closures = real
        counts = dict(_build.launches)
        summary = json.loads(out_path.read_text())
    keep["cli"] = summary
    record = [json.loads(line) for line in log.getvalue().splitlines() if line.startswith("{")][-1]
    stages = record["stage_seconds"]
    print(f"exit {rc_cli} in {cli_wall:.3f} s: {summary['num_tracks']} tracks, {summary['num_points']} points, "
          f"{summary['num_loop_closures']} loop closures; stage s (spans): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    print(f"kernels launched by the CLI run: {counts}; kernel 4 in the closure step: "
          f"{closure_launches.get('match', 0)}", flush=True)
    for name in ("base_stage", "fused_octave", "describe", "match"):
        if counts[name] <= 0:
            fail(f"SfM CLI: kernel {name} was not launched")
    if rc_cli != 0 or summary["num_frames"] != T or not np.isfinite(np.asarray(summary["poses"])).all():
        fail("SfM CLI: bad exit code, frame count or non-finite poses")
    if not closure_launches.get("match", 0) > 0 or summary["num_loop_closures"] < 1:
        fail("SfM CLI: the closure step launched no kernel 4 or found no closure")
    res_out["cli"] = {"frames": T, "batch": batch, "wall_s": cli_wall, "stage_s": stages,
                      "tracks": summary["num_tracks"], "points": summary["num_points"],
                      "loop_closures": summary["num_loop_closures"],
                      "launches": counts, "closure_match_launches": closure_launches["match"]}
    out["sfm"] = res_out


# ---------------------------------------------------------------- phase 8: the parallel paths

PIPE_FRAMES, PIPE_MICROBATCH = 24, 4
DP_FRAMES = 128


def rank_report(mesh, what: dict) -> dict:
    from akaze_tpu_torch.parallel.distributed import backend

    return {"rank": mesh.rank, "device": str(mesh.device), "backend": backend(), **what}


def job_dp(torch, np, work: Path, world: int, device: str) -> dict:
    """DP extract: this rank's DP_FRAMES / world frames, 1 warm-up and 3
    timed passes (CUDA events on this rank), then the gather."""
    import torch.distributed as dist

    from akaze_tpu_torch import interop
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.parallel.mesh import extract_batch_sharded, gather_features, make_mesh, total_valid_keypoints

    mesh = make_mesh(world, device=device)
    frames = torch.from_numpy(np.load(work / "dp_frames.npy")).to(mesh.device)
    extract_batch_sharded(frames, mesh)
    torch.cuda.synchronize()
    _build.reset_launches()
    pass_ms, walls = [], []
    for _ in range(3):
        dist.barrier()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        feats = extract_batch_sharded(frames, mesh)
        b.record()
        torch.cuda.synchronize()
        pass_ms.append(a.elapsed_time(b))
        dist.barrier()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_build.launches)
    t0 = time.perf_counter()
    full = gather_features(feats, mesh)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    total = total_valid_keypoints(feats, mesh)
    if mesh.rank == 0:
        np.savez(work / "dp_out.npz", **interop.features_to_numpy(full))
    return rank_report(mesh, {"frames": int(feats.keypoints.x.shape[0]), "pass_ms": pass_ms,
                                     "pass_wall_ms": walls, "gather_ms": gather_ms, "total_valid": total,
                                     "launches": launches})


def job_spatial(torch, np, work: Path, world: int, device: str) -> dict:
    """Row-sharded FED of one VGA level: 1 warm-up, 1 timed call, gather."""
    import torch.distributed as dist

    from akaze_tpu_torch.parallel.collectives import all_gather
    from akaze_tpu_torch.parallel.mesh import make_mesh
    from akaze_tpu_torch.parallel.spatial import sharded_fed_cycle

    mesh = make_mesh(world, device=device)
    with np.load(work / "fed_level.npz") as f:
        lt, g = (torch.from_numpy(f[k]).to(mesh.device) for k in ("lt", "g"))
        taus = [float(t) for t in f["taus"]]
    sharded_fed_cycle(lt, g, taus, mesh)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    block = sharded_fed_cycle(lt, g, taus, mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    full = all_gather([block], mesh)[0]
    if mesh.rank == 0:
        np.save(work / f"fed_out_{world}.npy", full.cpu().numpy())
    return rank_report(mesh, {"rows": int(block.shape[0]), "steps": len(taus), "ms": ms})


def _sfm_run(torch, mesh, scene, **kw):
    import torch.distributed as dist

    from akaze_tpu_torch.core.config import RansacConfig, SfmConfig
    from akaze_tpu_torch.sfm.incremental import run_incremental
    from akaze_tpu_torch.sfm.metrics import ate_rmse, camera_centers

    gt, obs, closures = scene
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_incremental(obs, len(gt), SfmConfig(ba_iterations=8), RansacConfig(num_iterations=256,
                          inlier_threshold=5e-3), ba_every=8, closures=closures or None, mesh=mesh, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, ate_rmse(camera_centers(res.poses), camera_centers(gt))


def job_ba50(torch, np, work: Path, world: int, device: str) -> dict:
    """BASELINE config 5 through run_incremental(mesh=): 2 runs."""
    from akaze_tpu_torch.parallel.mesh import make_mesh
    from akaze_tpu_torch.utils.synthetic import sfm_scene

    mesh = make_mesh(world, device=device)
    scene = sfm_scene(50, 600, seed=0, obs_noise=5e-4)
    (r1, w1, a1), (r2, w2, a2) = (_sfm_run(torch, mesh, scene) for _ in range(2))
    if mesh.rank == 0:
        np.savez(work / "ba50_out.npz", poses1=r1.poses, points1=r1.points, poses2=r2.poses, points2=r2.points,
                 tracks1=np.array(sorted(r1.track_point)), tracks2=np.array(sorted(r2.track_point)))
    return rank_report(mesh, {"wall_s": [w1, w2], "ate": [a1, a2]})


def job_k200(torch, np, work: Path, world: int, device: str) -> dict:
    """One K = 200 window problem of the loop scene (the CG solve), sharded."""
    import torch.distributed as dist

    from akaze_tpu_torch import interop
    from akaze_tpu_torch.core.config import SfmConfig
    from akaze_tpu_torch.parallel.mesh import make_mesh
    from akaze_tpu_torch.sfm.ba import bundle_adjust_sharded

    mesh = make_mesh(world, device=device)
    with np.load(work / "k200_problem.npz") as f:
        problem = interop.ba_problem_from_numpy(dict(f), device=mesh.device)
        iterations = int(f["iterations"])
    shard = interop.ba_problem_shards(problem, mesh.size)[mesh.rank]
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = bundle_adjust_sharded(shard, SfmConfig(ba_iterations=iterations), mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if mesh.rank == 0:
        np.save(work / "k200_out.npy", out.poses.cpu().numpy())
    return rank_report(mesh, {"points": int(shard.points.shape[0]), "ms": ms})


def job_kf200(torch, np, work: Path, world: int, device: str) -> dict:
    """The 200-keyframe loop scene end to end through run_incremental(mesh=)."""
    from akaze_tpu_torch.parallel.mesh import make_mesh
    from akaze_tpu_torch.utils.synthetic import sfm_scene

    mesh = make_mesh(world, device=device)
    res, wall, ate = _sfm_run(torch, mesh, sfm_scene(200, 5000, seed=0, loop=True, obs_noise=2e-3))
    return rank_report(mesh, {"wall_s": wall, "ate": ate, "valid_points": len(res.track_point),
                                     "finite": bool(np.isfinite(res.poses).all())})


def job_pipeline(torch, np, work: Path, world: int, device: str) -> dict:
    """The 3-stage pipeline on a (3, world / 3) mesh, on JAX's per-frame
    draws, timed once after the launch counts are zeroed."""
    import torch.distributed as dist

    from akaze_tpu_torch.interop import jax_uniform
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.parallel.pipeline_stage import make_stage_mesh, pipelined_stream

    mesh = make_stage_mesh(world // 3, device=device)
    frames = np.load(work / "pipe_frames.npy")
    _build.reset_launches()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipelined_stream(frames, mesh, microbatch=PIPE_MICROBATCH,
                           draws=lambda f, shape: jax_uniform(0, shape, fold_in=f))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if mesh.rank == 0:
        np.savez(work / f"pipe_out_{world}.npz", **res)
    return rank_report(mesh, {"stage": mesh.axis_index("stage"), "lane": mesh.axis_index("data"),
                                     "wall_s": wall, "launches": dict(_build.launches)})


def job_cli(torch, np, work: Path, world: int, device: str) -> dict:
    """The sfm CLI with --mesh world, this process being one of the ranks
    torch.distributed.run started; the CLI starts and ends the process
    group itself."""
    from akaze_tpu_torch.cli import sfm as cli_sfm
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.parallel.distributed import rank_device

    _build.reset_launches()
    t0 = time.perf_counter()
    rc = cli_sfm.main([str(work / "cli_frames.npy"), "-o", str(work / "cli_out.json"), "--batch", "16",
                       "--device", device, "--mesh", str(world)])
    torch.cuda.synchronize()
    return {"rank": int(os.environ["RANK"]), "device": str(rank_device(device)), "rc": rc,
            "wall_s": time.perf_counter() - t0, "launches": dict(_build.launches)}


RANK_JOBS = {"dp": job_dp, "spatial": job_spatial, "ba50": job_ba50, "k200": job_k200, "kf200": job_kf200,
             "pipeline": job_pipeline, "cli": job_cli}


def rank_main(args) -> int:
    """One rank of phase 8 (started by phase_parallel): joins the process
    group (or, under torch.distributed.run, leaves that to the CLI), runs
    its jobs and writes their reports to the work directory."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from akaze_tpu_torch.parallel import distributed
    except ImportError as e:
        fail(f"the akaze_tpu_torch package is not next to this script ({e})")
    work = Path(args.workdir)
    jobs = args.jobs.split(",")
    if args.rank is None:  # started by torch.distributed.run
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        rank, world = args.rank, args.world
        distributed.initialize(f"tcp://127.0.0.1:{args.port}", world_size=world, rank=rank, device=args.device,
                               timeout_s=240)
    reports = {job: RANK_JOBS[job](torch, np, work, world, args.device) for job in jobs}
    (work / f"rank{rank}_{'_'.join(jobs)}.json").write_text(json.dumps(reports))
    distributed.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(work: Path, jobs: str, world: int, device, timeout: float, torchrun: bool = False) -> list:
    """Run `world` ranks of this script's `jobs` on `device` (all started
    together, or by torch.distributed.run) to their end within `timeout`
    seconds; every process is killed on a failure.  Returns the ranks'
    reports in rank order."""
    me = [str(Path(__file__).resolve()), "--jobs", jobs, "--workdir", str(work), "--device", str(device.type)]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK", "LOCAL_"))}
    if torchrun:
        cmds = [[sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(world), *me]]
    else:
        port = free_port()
        cmds = [[sys.executable, *me, "--rank", str(r), "--world", str(world), "--port", str(port)]
                for r in range(world)]
    logs = [work / f"log_{jobs.replace(',', '_')}_{world}_{i}.txt" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, env=env, start_new_session=True))
        deadline = time.time() + timeout
        for p, log in zip(procs, logs):
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                fail(f"phase 8 {jobs} on {world} ranks: no end within {timeout:.0f} s:\n{log.read_text()[-3000:]}")
            if p.returncode != 0:
                fail(f"phase 8 {jobs} on {world} ranks exited {p.returncode}:\n{log.read_text()[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    name = "_".join(jobs.split(","))
    return [json.loads((work / f"rank{r}_{name}.json").read_text()) for r in range(world)]


def sharded_ba_in_one_process(torch, np, arrays: dict, config, n: int, device):
    """The poses of an n-rank bundle_adjust_sharded of `arrays` computed in
    this process: one thread per shard, whose `reduce` adds the shards'
    partial sums in rank order (what parallel.collectives.all_sum does
    across processes).  The rank processes must give these bits."""
    import threading

    from akaze_tpu_torch import interop
    from akaze_tpu_torch.sfm import ba

    shards = interop.ba_problem_shards(interop.ba_problem_from_numpy(arrays, device=device), n)
    parts, out, barrier = [None] * n, [None] * n, threading.Barrier(n)

    def run(r):
        def reduce(x):
            parts[r] = x
            barrier.wait()
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            barrier.wait()
            return acc

        out[r] = ba._lm_loop(shards[r].replace(obs_cam=shards[r].obs_cam.long()), config, reduce=reduce)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out[0].poses.cpu().numpy()


def phase_parallel(torch, np, dev, keep: dict, out: dict) -> None:
    """Phase 8: the parallel paths, rank processes sharing the card (see
    the module doc)."""
    import tempfile

    from akaze_tpu_torch import interop
    from akaze_tpu_torch.cli import sfm as cli_sfm
    from akaze_tpu_torch.core.config import AkazeConfig, RansacConfig, SfmConfig
    from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch
    from akaze_tpu_torch.frontend.scale_space import conductivity, fed_cycle, gaussian_blur, scharr
    from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
    from akaze_tpu_torch.kernels.fed import base_stage_plain
    from akaze_tpu_torch.parallel.distributed import choose_backend
    from akaze_tpu_torch.parallel.pipeline_stage import sequential_stream
    from akaze_tpu_torch.sfm.incremental import run_incremental
    from akaze_tpu_torch.sfm.metrics import camera_centers
    from akaze_tpu_torch.utils.synthetic import textured_scene, video_sequence

    H, W = 480, 640
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"\n== parallel paths: rank processes sharing {torch.cuda.device_count()} card(s), compute mode {mode}; "
          f"backend for 2 ranks on this host: {choose_backend(dev, 2)}", flush=True)
    res = {"compute_mode": mode, "cards": torch.cuda.device_count()}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # Inputs and the single-rank references, made here before any rank starts.
        dp_frames = video_sequence(DP_FRAMES, H, W, seed=60)
        np.save(work / "dp_frames.npy", dp_frames)
        dp_ref = interop.features_to_numpy(extract_batch(dp_frames, device=dev))
        config = AkazeConfig()
        ss, _ = _statics(W, H, config)
        level = 1  # octave 0's first diffused level
        spec = ss.specs[level]
        if spec.octave != 0 or not spec.taus:
            fail(f"level {level} is not a diffused level of octave 0")
        seed, modg = base_stage_plain(torch.from_numpy(video_sequence(1, H, W, seed=61)).to(dev),
                                      float(config.base_scale_offset))
        k = contrast_factor_from_modg(modg, config)
        lsmooth = gaussian_blur(seed, 1.0)
        g = conductivity(scharr(lsmooth, 1, 0, 1), scharr(lsmooth, 0, 1, 1), k.reshape(-1, 1, 1),
                         config.diffusivity)
        lt, g = seed[0].contiguous(), g[0].contiguous()
        np.savez(work / "fed_level.npz", lt=lt.cpu().numpy(), g=g.cpu().numpy(), taus=np.asarray(spec.taus))
        fed_ref = fed_cycle(lt, g, spec.taus).cpu().numpy()
        k200_problem, k200_poses, k200_cfg = keep["k200"]
        np.savez(work / "k200_problem.npz", **k200_problem, iterations=k200_cfg.ba_iterations)
        k200_emulated = sharded_ba_in_one_process(torch, np, k200_problem, k200_cfg, 2, dev)
        from akaze_tpu_torch.sfm.ba import bundle_adjust

        k200_cpu = bundle_adjust(interop.ba_problem_from_numpy(k200_problem, device="cpu"), k200_cfg).poses.numpy()
        pipe_frames = video_sequence(PIPE_FRAMES, H, W, seed=21)
        np.save(work / "pipe_frames.npy", pipe_frames)
        pipe_ref = sequential_stream(pipe_frames, draws=lambda f, shape: interop.jax_uniform(0, shape, fold_in=f),
                                     device=dev)
        cli_frames = revisit_frames(np, textured_scene, 64, H, W)
        np.save(work / "cli_frames.npy", cli_frames)
        # The CLI scene's own spread under float32 reordering: its SfM on the
        # CPU, on the front end's tracks and closures, against phase 7's card run.
        cli_args = argparse.Namespace(intrinsics=None, batch=16, no_loop_closure=False, loop_min_gap=8,
                                      loop_min_matches=60, loop_min_inliers=30)
        n_cli, _, cli_obs, cli_closures = cli_sfm._front_end(cli_args, cli_frames, config, dev)
        cli_cpu = run_incremental(cli_obs, n_cli, SfmConfig(ba_iterations=10), RansacConfig(), closures=cli_closures,
                                  device="cpu")
        cli_spread = float(np.abs(camera_centers(cli_cpu.poses) - np.asarray(keep["cli"]["camera_centers"])).max())
        del dp_frames
        torch.cuda.empty_cache()
        print(f"inputs and single-rank references: {time.perf_counter() - t_phase:.1f} s", flush=True)

        # Two ranks: DP extract, spatial, the sharded BA runs.
        t0 = time.perf_counter()
        pair = run_ranks(work, "dp,spatial,ba50,k200,kf200", 2, dev, timeout=420)
        pair_wall = time.perf_counter() - t0
        print(f"2 ranks (one process each, {pair_wall:.1f} s with start-up): " + "; ".join(
            f"rank {r['dp']['rank']} on {r['dp']['device']} backend {r['dp']['backend']}" for r in pair), flush=True)
        # ---- DP extract
        got = dict(np.load(work / "dp_out.npz"))
        same = sorted(got) == sorted(dp_ref) and all(np.array_equal(got[k], v) for k, v in dp_ref.items())
        pass_ms = [max(r["dp"]["pass_ms"][i] for r in pair) for i in range(3)]
        wall_ms = [max(r["dp"]["pass_wall_ms"][i] for r in pair) for i in range(3)]
        dp_launch = [r["dp"]["launches"] for r in pair]
        print(f"DP extract, {DP_FRAMES} VGA frames over 2 ranks ({pair[0]['dp']['frames']} each): pass ms by rank "
              + ", ".join(f"rank {r['dp']['rank']} {[round(x, 3) for x in r['dp']['pass_ms']]}" for r in pair)
              + f"; slowest rank per pass {[round(x, 3) for x in pass_ms]} ({[round(DP_FRAMES / (x / 1e3), 1) for x in pass_ms]}"
              f" frames/s, ranks sharing one card), barrier-to-barrier {[round(x, 3) for x in wall_ms]} ms; gather "
              f"{pair[0]['dp']['gather_ms']:.3f} ms; {pair[0]['dp']['total_valid']} valid keypoints; gathered "
              f"features {'bit-equal' if same else 'DIFFERENT'} to extract_batch on one rank", flush=True)
        for r, ln in enumerate(dp_launch):
            print(f"  rank {r} launches over the 3 timed passes: {ln}", flush=True)
        if not same:
            fail("DP extract: the gathered features differ from single-rank extract_batch")
        if pair[0]["dp"]["total_valid"] != int(dp_ref["valid"].sum()):
            fail("DP extract: total_valid_keypoints differs from the single-rank count")
        for r, ln in enumerate(dp_launch):
            for name in ("base_stage", "fused_octave", "describe"):
                if ln[name] <= 0:
                    fail(f"DP extract: rank {r} launched no {name}")
        res["dp"] = {"frames": DP_FRAMES, "ranks": 2, "pass_ms_by_rank": [r["dp"]["pass_ms"] for r in pair],
                     "pass_ms": pass_ms, "frames_per_s": [DP_FRAMES / (x / 1e3) for x in pass_ms],
                     "barrier_wall_ms": wall_ms, "gather_ms": pair[0]["dp"]["gather_ms"], "bit_equal": same,
                     "launches_by_rank": dp_launch}

        # ---- spatial, 2 ranks here and 4 below
        quad = run_ranks(work, "spatial", 4, dev, timeout=180)
        sp = {}
        for world, reports in ((2, pair), (4, quad)):
            got = np.load(work / f"fed_out_{world}.npy")
            eq = np.array_equal(got, fed_ref)
            sp[world] = {"ms_by_rank": [r["spatial"]["ms"] for r in reports], "bit_equal": eq}
            print(f"spatial: level {level} ({H}x{W}, {len(spec.taus)} FED steps) over {world} ranks of "
                  f"{reports[0]['spatial']['rows']} rows: ms by rank {[round(r['spatial']['ms'], 3) for r in reports]}; "
                  f"{'bit-equal' if eq else 'DIFFERENT'} to fed_cycle", flush=True)
            if not eq:
                fail(f"spatial: {world} ranks differ from fed_cycle")
        res["spatial"] = {"level": level, "steps": len(spec.taus), **{f"ranks_{w}": v for w, v in sp.items()}}

        # ---- sharded BA: BASELINE config 5 against phase 7's single-rank run
        kf50, ate_one = keep["kf50"]
        with np.load(work / "ba50_out.npz") as f:
            b50 = dict(f)
        same_runs = np.array_equal(b50["poses1"], b50["poses2"]) and np.array_equal(b50["points1"], b50["points2"])
        d_c = float(np.abs(camera_centers(b50["poses2"]) - camera_centers(kf50.poses)).max())
        same_valid = list(b50["tracks2"]) == sorted(kf50.track_point)
        w50 = pair[0]["ba50"]["wall_s"]
        ate50 = pair[0]["ba50"]["ate"]
        # The centers' gate: a float32 reordering of the single-rank run
        # itself moves them 8.9e-3 on this scene (4 against 1 CPU threads,
        # tools/sfm_parity.py), so 1e-2, with the ATE held to 1e-4.
        print(f"BA: BASELINE config 5 through run_incremental(mesh=2 ranks): runs {[round(x, 3) for x in w50]} s, "
              f"{50 / w50[1]:.2f} keyframes/s (run 2), ATE {ate50[0]:.5f} / {ate50[1]:.5f} (gate 0.05; one rank "
              f"{ate_one:.5f}, gate 1e-4 from it), runs {'bit-equal' if same_runs else 'DIFFERENT'}; against phase 7's "
              f"single-rank run: valid points {len(b50['tracks2'])} / {len(kf50.track_point)} "
              f"({'same' if same_valid else 'DIFFERENT'}), camera centers max |diff| {d_c:.3e} (gate 1e-2)", flush=True)
        if not (max(ate50) < 0.05 and abs(ate50[1] - ate_one) < 1e-4 and same_runs and same_valid and d_c < 1e-2):
            fail("sharded BA, BASELINE config 5: ATE, rerun equality, valid points or camera centers out of gate")
        got = np.load(work / "k200_out.npy")
        d200 = float(np.abs(got - k200_poses).max())
        exact = np.array_equal(got, k200_emulated)
        d_cpu = float(np.abs(k200_cpu - k200_poses).max())
        print(f"BA: one K = 200 window problem of the loop scene ({k200_problem['points'].shape[0]} point rows, "
              f"CG solve), sharded over 2 ranks: {[round(r['k200']['ms'], 3) for r in pair]} ms by rank; poses "
              f"{'bit-equal' if exact else 'DIFFERENT'} to the same sums added in one process; max |diff| against "
              f"the single-rank BA {d200:.3e} (gate 5e-3; the single-rank BA on the CPU, another summation order, "
              f"{d_cpu:.3e} from it)", flush=True)
        if not (exact and d200 < 5e-3):
            fail(f"sharded BA, K = 200 problem: not the one-process sums, or poses {d200:.3e} from the single-rank BA")
        kf = pair[0]["kf200"]
        print(f"BA: the 200-keyframe loop scene through run_incremental(mesh=2 ranks): {kf['wall_s']:.3f} s, "
              f"{200 / kf['wall_s']:.2f} keyframes/s, ATE {kf['ate']:.5f} (printed, not gated; phase 7's single "
              f"rank: {keep['kf200_ate']:.5f}), {kf['valid_points']} valid points", flush=True)
        if not all(r["kf200"]["finite"] for r in pair):
            fail("the 200-keyframe run over 2 ranks gave non-finite poses")
        res["ba"] = {"kf50": {"wall_s": w50, "keyframes_per_s": 50 / w50[1], "ate": ate50, "ate_one_rank": ate_one,
                              "bit_equal_runs": same_runs,
                              "same_valid_points": same_valid, "centers_max_diff": d_c},
                     "k200_problem": {"ms_by_rank": [r["k200"]["ms"] for r in pair], "poses_max_diff": d200,
                                      "bit_equal_one_process": exact, "single_cpu_max_diff": d_cpu},
                     "kf200": {"wall_s": kf["wall_s"], "keyframes_per_s": 200 / kf["wall_s"], "ate": kf["ate"],
                               "valid_points": kf["valid_points"]}}

        # ---- pipeline on 3 and 6 ranks
        pipe = {}
        for world in (3, 6):
            reports = [r["pipeline"] for r in run_ranks(work, "pipeline", world, dev, timeout=240)]
            with np.load(work / f"pipe_out_{world}.npz") as f:
                counts, inl = f["match_counts"], f["pose_inliers"]
            c_eq = np.array_equal(counts, pipe_ref["match_counts"])
            d_inl = int(np.abs(inl - pipe_ref["pose_inliers"]).max())
            total = {n: sum(r["launches"][n] for r in reports) for n in ("base_stage", "fused_octave", "describe",
                                                                      "match")}
            print(f"pipeline: {PIPE_FRAMES} VGA frames, microbatch {PIPE_MICROBATCH}, (stage, data) = (3, "
                  f"{world // 3}): {max(r['wall_s'] for r in reports):.3f} s; match counts "
                  f"{'equal' if c_eq else 'DIFFERENT'} to the sequential single-rank path, pose inliers max |diff| "
                  f"{d_inl} (gate 2)", flush=True)
            for r in reports:
                print(f"  rank {r['rank']} (stage {r['stage']}, lane {r['lane']}, {r['device']}, {r['backend']}): "
                      f"launches {r['launches']}", flush=True)
            if not (c_eq and d_inl <= 2):
                fail(f"pipeline on {world} ranks: counts differ or inliers beyond 2")
            for n, v in total.items():
                if v <= 0:
                    fail(f"pipeline on {world} ranks: kernel {n} was not launched")
            pipe[f"ranks_{world}"] = {"wall_s": max(r["wall_s"] for r in reports), "counts_equal": c_eq,
                                      "inliers_max_diff": d_inl,
                                      "launches_by_rank": [r["launches"] for r in reports]}
        res["pipeline"] = {"frames": PIPE_FRAMES, "microbatch": PIPE_MICROBATCH, **pipe}

        # ---- the sfm CLI with --mesh 2 under torch.distributed.run
        t0 = time.perf_counter()
        cli = [r["cli"] for r in run_ranks(work, "cli", 2, dev, timeout=300, torchrun=True)]
        cli_wall = time.perf_counter() - t0
        got, ref = json.loads((work / "cli_out.json").read_text()), keep["cli"]
        d_cli = float(np.abs(np.asarray(got["camera_centers"]) - np.asarray(ref["camera_centers"])).max())
        keys = ("num_frames", "num_tracks", "num_points", "num_loop_closures")
        print(f"sfm CLI --mesh 2 under torch.distributed.run ({cli_wall:.1f} s with start-up; ranks "
              f"{[round(r['wall_s'], 3) for r in cli]} s): " + ", ".join(f"{k} {got[k]} / {ref[k]}" for k in keys)
              + f" (--mesh 2 / phase 7's --mesh 0); camera centers max |diff| {d_cli:.3e}, trajectory within "
              f"{np.abs(np.asarray(ref['camera_centers'])).max():.3f} of the origin (printed, not gated: the scene is "
              f"one textured plane, and the same SfM on the CPU, another summation order, lands {cli_spread:.3e} from "
              "phase 7's card run)", flush=True)
        for r in cli:
            print(f"  rank {r['rank']} on {r['device']}: exit {r['rc']}, launches {r['launches']}", flush=True)
        if (any(r["rc"] != 0 for r in cli) or any(got[k] != ref[k] for k in keys)
                or not np.isfinite(np.asarray(got["poses"])).all()):
            fail("sfm CLI --mesh 2: a rank failed, the tracks, points or closures differ from the --mesh 0 run, or "
                 "a pose is not finite")
        for n in ("base_stage", "fused_octave", "describe", "match"):
            if sum(r["launches"][n] for r in cli) <= 0:
                fail(f"sfm CLI --mesh 2: kernel {n} was not launched")
        res["cli"] = {"wall_s": cli_wall, "rank_wall_s": [r["wall_s"] for r in cli], "centers_max_diff": d_cli,
                      "cpu_centers_max_diff": cli_spread,
                      "launches_by_rank": [r["launches"] for r in cli]}
    by_rank = (res["dp"]["launches_by_rank"] + res["cli"]["launches_by_rank"]
               + [x for w in (3, 6) for x in res["pipeline"][f"ranks_{w}"]["launches_by_rank"]])
    res["launches"] = {n: sum(ln[n] for ln in by_rank) for n in by_rank[0]}
    print(f"kernels launched on phase 8's paths (all ranks): {res['launches']}", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 8: {res['phase_s']:.1f} s", flush=True)
    out["parallel"] = res


# ---------------------------------------------------------------- phase 9: oracles and conductivity variants


def ulp_gap(torch, a, b) -> int:
    """The largest ULP distance between two float32 tensors (int32 tensors:
    the largest absolute difference)."""
    if a.dtype != torch.float32:
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0
    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def oracle_gates(np, got: dict, ref: dict) -> dict:
    """tests/test_scene_regression.py's numbers for `got` (one frame's
    features_to_numpy arrays) against `ref` (an oracle's, same keys):
    counts, the share of got's keypoints within 0.5 px of one of ref's and
    the reverse, and the median Hamming distance over got's matched
    keypoints (by position)."""
    v = got["valid"]
    gx, gy, gd = got["x"][v], got["y"][v], got["descriptors"][v]
    n_got, n_ref = int(v.sum()), len(ref["x"])
    if not n_got or not n_ref:
        return {"n": n_got, "n_ref": n_ref, "got_to_ref": float(n_got == n_ref), "ref_to_got": float(n_got == n_ref),
                "median_bits": 0.0}
    d2 = (gx[:, None] - ref["x"][None, :]) ** 2 + (gy[:, None] - ref["y"][None, :]) ** 2
    dmin = np.sqrt(d2.min(1))
    ok = dmin < 0.5
    ham = np.bitwise_count(ref["descriptors"][d2.argmin(1)[ok]] ^ gd[ok]).sum(1)
    return {"n": n_got, "n_ref": n_ref, "got_to_ref": float(ok.mean()),
            "ref_to_got": float((np.sqrt(d2.min(0)) < 0.5).mean()),
            "median_bits": float(np.median(ham)) if len(ham) else 0.0}


def phase_oracles(torch, np, dev, root: Path, card: str, reset_counts, main_fps: float, main_best: float,
                  out: dict) -> None:
    """Phase 9: BASELINE config 3 (the g1 and Weickert conductivities)
    through kernels 1-3 and 5 at full width, held against the plain twins
    bit for bit; the native single-core C++ baseline on this host; the card
    against the golden NumPy model's scene snapshots and against the native
    extract and matcher.  Every miss fails the run.  `out["oracles"]` gets
    the numbers and each kernel's launches on this phase's paths (not
    counting the launches that hold a kernel against its twin).  main_fps
    and main_best: phase 3's main-path frames/s (mean and best pass)."""
    from akaze_tpu_torch import interop, native
    from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig
    from akaze_tpu_torch.frontend.pipeline import _statics, extract, extract_batch, extract_fn
    from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg, half_size
    from akaze_tpu_torch.golden import akaze as golden
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.kernels.fed import (
        base_stage_plain, fused_level_batched, fused_level_batched_plain, fused_octave, fused_octave_plain,
    )
    from akaze_tpu_torch.matching.hamming import match_features
    from akaze_tpu_torch.utils.synthetic import SCENE_CLASSES, textured_scene, video_sequence

    t_phase = time.perf_counter()
    res = {"launches": dict.fromkeys(_build.launches, 0)}

    def path_launches() -> dict:
        """The counts since the last reset, added to the phase's."""
        got = dict(_build.launches)
        for name, n in got.items():
            res["launches"][name] += n
        return got

    # ---- a. host and compiler
    print("\n== phase 9: oracles and conductivity variants", flush=True)
    cpu = native.cpu_model()
    print(f"host CPU: {cpu}; compiler: {native.compiler_version()}", flush=True)
    t0 = time.perf_counter()
    try:
        lib = native.build()
    except RuntimeError as e:
        fail(f"the native library did not build: {e}")
    if not native.available():
        fail("the native library built but does not load")
    print(f"native build (g++ {' '.join(native.CXX_FLAGS)}): {time.perf_counter() - t0:.1f} s, "
          f"{lib.relative_to(root)}", flush=True)
    res.update(cpu=cpu, compiler=native.compiler_version(), card=card)

    # ---- b. config 3 at full width: batch 64 VGA, seeds 0-2 (bench.py:286-318)
    B, H, W = 64, 480, 640
    sets = [torch.from_numpy(video_sequence(B, H, W, seed=s)).to(dev) for s in (0, 1, 2)]
    res["config3"] = {}
    for diff in (Diffusivity.PM_G1, Diffusivity.WEICKERT):
        cfg = AkazeConfig(diffusivity=diff)
        extract_batch(sets[0], cfg, device=dev)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        ms, counts = [], []
        for frames in sets:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            feats = extract_batch(frames, cfg, device=dev)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            kp = feats.keypoints
            counts.append(int(kp.count().sum()))
            if not (torch.isfinite(kp.x[kp.valid]).all() and torch.isfinite(kp.angle).all()):
                fail(f"config 3 {diff.value}: non-finite keypoint output")
            if feats.descriptors.shape != (B, cfg.max_keypoints, 16):
                fail(f"config 3 {diff.value}: descriptor shape {tuple(feats.descriptors.shape)}")
        launches = path_launches()
        for name in ("base_stage", "fused_octave", "describe"):
            if launches[name] <= 0:
                fail(f"config 3 {diff.value}: kernel {name} was not launched")
        if len(set(counts)) < 2:
            fail(f"config 3 {diff.value}: distinct inputs gave identical keypoint counts")
        fps = [B / (t / 1e3) for t in ms]
        print(f"config 3 {diff.value}: extract_batch batch {B} VGA, passes (ms) {[round(t, 3) for t in ms]}, "
              f"frames/s {[round(f, 1) for f in fps]} (mean {sum(fps) / len(fps):.1f}), keypoints/frame "
              f"{sum(counts) / (B * len(sets)):.1f}; launches {launches} [{card}]", flush=True)

        # Kernel 2 against its twin on one batch, each octave fed the plain chain's seed.
        ss, _ = _statics(W, H, cfg)
        groups = ss.groups
        seed, modg = base_stage_plain(sets[0], float(cfg.base_scale_offset))
        k = contrast_factor_from_modg(modg, cfg)
        for oi, (l0, n, h, w) in enumerate(groups):
            if oi:
                k = k * cfg.contrast_octave_decay
            argv = (seed, k, tuple(ss.specs[l0 : l0 + n]), diff, oi == 0, float(cfg.detector_threshold),
                    oi + 1 < len(groups))
            got, ref = fused_octave(*argv), fused_octave_plain(*argv)
            for name, g, r in zip(("Lt", "Lx", "Ly", "score", "sub", "half"), got, ref):
                if not ((g is None and r is None) or torch.equal(g, r)):
                    fail(f"config 3 {diff.value}: kernel 2 octave {oi} {name} differs from its twin by up to "
                         f"{ulp_gap(torch, g, r)} ULP (bit-equality required)")
            seed = ref[5]
        print(f"  kernel 2 ({diff.value}, kind {list(Diffusivity).index(diff)}): {len(groups)} octaves of batch "
              f"{B} VGA bit-equal to fused_octave_plain (Lt, Lx, Ly, score, sub, half)", flush=True)

        # Kernel 5 through extract_fn on one VGA frame, then level by level against its twin.
        frame = sets[1][0]
        reset_counts()
        fk = extract_fn(frame, cfg)
        torch.cuda.synchronize()
        launches_b = path_launches()
        for name in ("base_stage", "fused_level"):
            if launches_b[name] <= 0:
                fail(f"config 3 {diff.value}: extract_fn did not launch kernel {name}")
        fp = extract_fn(frame, cfg, plain=True)
        if not (torch.equal(fk.keypoints.valid, fp.keypoints.valid) and torch.equal(fk.keypoints.x, fp.keypoints.x)
                and torch.equal(fk.keypoints.y, fp.keypoints.y) and torch.equal(fk.descriptors, fp.descriptors)):
            fail(f"config 3 {diff.value}: extract_fn through the kernels differs from the plain twins")
        seed5, modg5 = base_stage_plain(frame[None].contiguous(), float(cfg.base_scale_offset))
        k5 = contrast_factor_from_modg(modg5, cfg)
        for i, spec in enumerate(ss.specs):
            if i > 0 and spec.octave > ss.specs[i - 1].octave:
                seed5, k5 = half_size(seed5).contiguous(), k5 * cfg.contrast_octave_decay
            got = fused_level_batched(seed5, k5, spec, diff, i == 0)
            ref = fused_level_batched_plain(seed5, k5, spec, diff, i == 0)
            for name, g, r in zip(("Lt", "Lx", "Ly", "Ldet"), got, ref):
                if not torch.equal(g, r):
                    fail(f"config 3 {diff.value}: kernel 5 level {i} {name} differs from its twin by up to "
                         f"{ulp_gap(torch, g, r)} ULP (bit-equality required)")
            seed5 = ref[0]
        print(f"  kernel 5 ({diff.value}): extract_fn on one VGA frame, {int(fk.keypoints.count())} keypoints, equal "
              f"to the plain path; {ss.num_levels} levels bit-equal to fused_level_batched_plain (Lt, Lx, Ly, Ldet); "
              f"launches {launches_b}", flush=True)
        res["config3"][diff.value] = {"ms": ms, "fps": fps, "fps_mean": sum(fps) / len(fps),
                                      "keypoints_per_frame": sum(counts) / (B * len(sets)),
                                      "launches": launches, "extract_fn_launches": launches_b}
    del sets, seed, modg, got, ref, fk, fp
    torch.cuda.empty_cache()

    # ---- c. the live single-core C++ baseline (bench.py:45-64, :255-268)
    pair = video_sequence(2, H, W, seed=1)
    card_fps = {"pm_g2": (main_fps, main_best)}
    for d in ("pm_g1", "weickert"):
        card_fps[d] = (res["config3"][d]["fps_mean"], max(res["config3"][d]["fps"]))
    res["baseline"] = {}
    for d in ("pm_g2", "pm_g1", "weickert"):
        sec = native.bench_pipeline_native(pair[0], pair[1], reps=3, diffusivity=d)
        if not 0.0 < sec < 60.0:
            fail(f"native baseline {d}: {sec} s per frame")
        mean, best = card_fps[d]
        res["baseline"][d] = {"s_per_frame": sec, "fps": 1.0 / sec, "card_fps_mean": mean, "card_fps_best": best,
                              "ratio_mean": mean * sec, "ratio_best": best * sec}
        print(f"native single-core baseline {d}: {1.0 / sec:.2f} frames/s (detect + describe + match, "
              f"video_sequence(2, 480, 640, seed=1), reps 3) on {cpu}; the card "
              f"({'phase 3 extract + match, batch 128' if d == 'pm_g2' else 'phase 9b extract, batch 64'}) mean "
              f"{mean:.1f}, best {best:.1f} frames/s: {mean * sec:.1f}x ({best * sec:.1f}x best) [{card}]", flush=True)

    # ---- d. the card against the golden model's snapshots, per scene class
    with np.load(root / "tests" / "data" / "golden_scene_snapshots.npz") as z:
        shape, seed_s = tuple(int(v) for v in z["image_shape"]), int(z["seed"])
        snaps = {k: z[k] for k in z.files}
    res["scenes"] = {}
    for name in sorted(SCENE_CLASSES):
        img = SCENE_CLASSES[name](*shape, seed=seed_s)
        reset_counts()
        got = interop.features_to_numpy(extract(img, AkazeConfig(), device=dev))
        launches = path_launches()
        if min(launches[n] for n in ("base_stage", "fused_octave", "describe")) <= 0:
            fail(f"scene {name}: the extract did not launch kernels 1-3")
        ref = {"x": snaps[f"{name}_x"], "y": snaps[f"{name}_y"],
               "descriptors": interop.pack_descriptor_bytes(snaps[f"{name}_descriptors"])}
        g = oracle_gates(np, got, ref)
        res["scenes"][name] = g
        print(f"scene {name} ({shape[1]}x{shape[0]}, seed {seed_s}): {g['n']} keypoints on the card, {g['n_ref']} in "
              f"the golden snapshot; within 0.5 px {g['got_to_ref']:.3f} / {g['ref_to_got']:.3f}, median "
              f"{g['median_bits']:.1f} bits", flush=True)
        if not (abs(g["n"] - g["n_ref"]) <= max(2, 0.1 * g["n_ref"]) and
                (g["n_ref"] == 0 or (g["got_to_ref"] >= 0.9 and g["ref_to_got"] >= 0.9 and g["median_bits"] <= 4))):
            fail(f"scene {name}: the card misses the snapshot gates (count within max(2, 10 %), >= 90 % within "
                 f"0.5 px both ways, median <= 4 bits)")

    # The golden copy on this machine's NumPy: the textured snapshot exactly,
    # on the image it was made from (numpy's float32 sin / exp differ by a
    # few ULP between numpy versions, so the generated scene may differ).
    with np.load(root / "tests" / "data" / "golden_snapshot.npz") as z:
        snap = {k: z[k] for k in z.files}
    with np.load(root / "tests" / "torch_data" / "golden_snapshot_image.npz") as z:
        stored = z["image"]
    shape_g, seed_g = tuple(int(v) for v in snap["image_shape"]), int(snap["seed"])
    t0 = time.perf_counter()
    gres = golden.extract(stored)
    g = interop.golden_to_numpy(gres)
    keys = ("x", "y", "response", "size", "octave", "class_id", "angle")
    exact = (len(g["x"]) == len(snap["x"]) and all(np.array_equal(g[k], snap[k]) for k in keys)
             and np.array_equal(gres.descriptors, snap["descriptors"]))
    here = textured_scene(*shape_g, seed=seed_g)
    ulps = int(np.abs(here.view(np.int32).astype(np.int64) - stored.view(np.int32)).max())
    ghere = interop.golden_to_numpy(golden.extract(here))
    same_here = len(ghere["x"]) == len(snap["x"]) and all(np.array_equal(ghere[k], snap[k]) for k in keys)
    print(f"golden copy (numpy {np.__version__}) on the snapshot's image ({shape_g[1]}x{shape_g[0]}, seed {seed_g}): "
          f"{len(g['x'])} keypoints, {'equal to' if exact else 'DIFFERENT from'} golden_snapshot.npz in every field "
          f"({time.perf_counter() - t0:.1f} s); the scene generated here is {int((here != stored).sum())} px / up to "
          f"{ulps} ULP from that image, and its golden output {'equals' if same_here else 'differs from'} the "
          f"snapshot", flush=True)
    if not exact:
        fail("the golden copy differs from tests/data/golden_snapshot.npz on its image")
    res["golden"] = {"exact": exact, "generated_scene_px": int((here != stored).sum()), "generated_scene_ulps": ulps,
                     "generated_scene_exact": same_here}

    # ---- e. the card against the native oracle at full width
    img = textured_scene(H, W, seed=0)
    res["native"] = {}
    for diff in (Diffusivity.PM_G2, Diffusivity.PM_G1, Diffusivity.WEICKERT):
        cfg = AkazeConfig(diffusivity=diff)
        nat = interop.native_to_numpy(*native.extract_native(img, cfg))
        reset_counts()
        got = interop.features_to_numpy(extract(img, cfg, device=dev))
        path_launches()
        g = oracle_gates(np, got, nat)
        res["native"][diff.value] = g
        print(f"native extract {diff.value} (textured_scene(480, 640, seed=0)): {g['n']} keypoints on the card, "
              f"{g['n_ref']} native; card -> native within 0.5 px {g['got_to_ref']:.3f} (gate 0.9), median "
              f"{g['median_bits']:.1f} bits (gate 4); native -> card {g['ref_to_got']:.3f} (printed: the "
              f"{cfg.per_level_candidates}-candidate cap per level drops some)", flush=True)
        if not (g["got_to_ref"] >= 0.9 and g["median_bits"] <= 4):
            fail(f"native extract {diff.value}: the card misses the gates against the native oracle")

    frames = video_sequence(2, H, W, seed=1)
    reset_counts()
    feats = extract_batch(frames, AkazeConfig(), device=dev)
    arr = interop.features_to_numpy(feats)
    ia, ib = np.nonzero(arr["valid"][0])[0], np.nonzero(arr["valid"][1])[0]
    res["match"] = {}
    for mutual in (True, False):
        mcfg = MatchConfig(mutual=mutual)
        m = match_features(feats.index(0), feats.index(1), mcfg, device=dev)
        acc, idx, dist = (x.cpu().numpy() for x in (m.accepted, m.idx_b, m.distance))
        n_idx, n_dist, n_acc = native.match_hamming_native(
            arr["descriptors"][0][ia], arr["descriptors"][1][ib], ratio=mcfg.ratio, mutual=mcfg.mutual,
            max_distance=mcfg.max_distance)
        want = {(int(ia[i]), int(ib[n_idx[i]])) for i in np.nonzero(n_acc)[0]}
        have = {(int(i), int(idx[i])) for i in np.nonzero(acc)[0]}
        same_dist = np.array_equal(dist[ia], n_dist)
        same_idx = np.array_equal(idx[ia], ib[n_idx])
        res["match"][f"mutual={mutual}"] = {"accepted": len(have), "native_accepted": len(want),
                                            "pairs_equal": have == want, "distances_equal": bool(same_dist)}
        print(f"match (kernel 4) against the native matcher, VGA pair video_sequence(2, 480, 640, seed=1), "
              f"mutual={mutual}: {len(have)} / {len(want)} accepted, pairs {'equal' if have == want else 'DIFFERENT'}, "
              f"best distances of all {len(ia)} rows {'equal' if same_dist else 'DIFFERENT'}, best indices "
              f"{'equal' if same_idx else 'different'}", flush=True)
        if have != want or not same_dist:
            fail(f"kernel 4's matcher and the native matcher disagree (mutual={mutual}): "
                 f"{len(have - want)} pairs only on the card, {len(want - have)} only native")
    launches = path_launches()
    if launches["match"] != 2:
        fail(f"the native comparison launched kernel 4 {launches['match']} times, expected 2")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"kernels launched on phase 9's paths: {res['launches']}", flush=True)
    print(f"phase 9: {res['phase_s']:.1f} s", flush=True)
    out["oracles"] = res


#: Phase 10a's cases and the keypoints the JAX package finds on each on the
#: CPU (tests/test_torch_degenerate.py holds both packages to these numbers
#: on the same images): name -> (image, small config).  The images are the
#: scenes of tests/test_degenerate_inputs.py, read from
#: tests/torch_data/degenerate_images.npz (numpy's float32 sin and exp differ
#: by a few ULP between numpy versions, so a scene generated elsewhere may
#: differ in a few pixels).
DEGENERATE_COUNTS = {"constant": 0, "sub_40px": 0, "kitti_1241x376": 458, "uint8": 12, "nan_block": 10}
#: tests/test_degenerate_inputs.py's small config.
DEGENERATE_SMALL = {"max_keypoints": 128, "per_level_candidates": 32}


def degenerate_inputs(np, root: Path) -> dict:
    """Phase 10a's inputs: name -> (image, whether the small config applies)."""
    with np.load(root / "tests" / "torch_data" / "degenerate_images.npz") as z:
        scene, sub40, kitti = z["scene_96x128"], z["scene_36x38"], z["scene_376x1241"]
    nan = scene.copy()
    nan[40:44, 60:64] = np.nan
    return {"constant": (np.full((96, 128), 0.5, np.float32), True), "sub_40px": (sub40, True),
            "kitti_1241x376": (kitti, False), "uint8": ((scene * 255).astype(np.uint8), True),
            "nan_block": (nan, True)}


def nan_pair_inputs(np, n: int = 64, seed: int = 0):
    """Phase 10b's correspondences: n points of a random scene before and
    after a 0.3 x-translation (R = I, t = (-1, 0, 0)), normalized (n, 3)
    x1, x2 and an all-true mask."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    p2 = pts + np.array([-0.3, 0.0, 0.0])
    return (pts / pts[:, 2:3]).astype(np.float32), (p2 / p2[:, 2:3]).astype(np.float32), np.ones(n, bool)


#: Phase 10b's cases: (rows of x1 set to NaN, whether the mask keeps them,
#: the inliers the JAX package finds on JAX's PRNGKey(0) draws; 0 comes
#: with a NaN pose, as every hypothesis held a NaN row).
NAN_PAIR_CASES = {"one_row": (slice(5, 6), True, 63), "one_row_masked_out": (slice(5, 6), False, 63),
                  "every_second_row": (slice(None, None, 2), True, 0)}


def phase_degenerate(torch, np, dev, root: Path, reset_counts, out: dict) -> None:
    """Phase 10: degenerate inputs through kernels 1-4 against the plain
    twins on the card, with the JAX package's counts (a); the NaN-pair
    RANSAC on the card against the CPU (b); bench_cuda.py's headline and
    two-view sections run as a user runs them (c).  `out["degenerate"]`
    gets the numbers and each kernel's launches on 10a's paths."""
    from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig, RansacConfig
    from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn
    from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
    from akaze_tpu_torch.geometry.twoview import estimate_relative_pose
    from akaze_tpu_torch.interop import jax_uniform
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.kernels.fed import base_stage_plain, fused_octave, fused_octave_plain
    from akaze_tpu_torch.matching.hamming import match, match_fn
    from akaze_tpu_torch.utils.synthetic import video_sequence

    t_phase = time.perf_counter()
    res = {"launches": dict.fromkeys(_build.launches, 0), "extract": {}, "match": {}}

    def path_launches() -> dict:
        got = dict(_build.launches)
        for name, n in got.items():
            res["launches"][name] += n
        return got

    def same_matches(m, p) -> bool:
        return all(torch.equal(getattr(m, k), getattr(p, k)) for k in ("idx_b", "distance", "accepted"))

    # ---- a. degenerate inputs: kernels 1-4 against the plain twins
    print("\n== phase 10a: degenerate inputs through kernels 1-4 and through the plain twins, on the card",
          flush=True)
    mcfg = MatchConfig()
    feats_of = {}
    for name, (img, small) in degenerate_inputs(np, root).items():
        cfg = AkazeConfig(**DEGENERATE_SMALL) if small else AkazeConfig()
        reset_counts()
        got = extract_batch(img[None], cfg, device=dev)
        kp, d = got.keypoints, got.descriptors
        m = match(d, kp.valid, d, kp.valid, mcfg, device=dev)  # the frame against itself
        torch.cuda.synchronize()
        launches = path_launches()
        ref = extract_batch_fn(torch.from_numpy(img[None]).to(dev), cfg, plain=True)
        mp = match_fn(ref.descriptors, ref.keypoints.valid, ref.descriptors, ref.keypoints.valid, mcfg, plain=True)
        fields = [f for f in ("valid", "x", "y", "response", "size", "angle", "octave", "class_id")
                  if not torch.equal(getattr(kp, f), getattr(ref.keypoints, f))]
        if not torch.equal(d, ref.descriptors):
            fields.append("descriptors")
        if not same_matches(m, mp):
            fields.append("matches")
        v = kp.valid[0]
        n = int(v.sum())
        h, w = img.shape
        finite = all(bool(torch.isfinite(getattr(kp, f)[0][v]).all()) for f in ("x", "y", "response", "size", "angle"))
        inside = bool(((kp.x[0][v] >= 0) & (kp.x[0][v] < w) & (kp.y[0][v] >= 0) & (kp.y[0][v] < h)).all())
        res["extract"][name] = {"shape": [h, w], "keypoints": n, "jax_keypoints": DEGENERATE_COUNTS[name],
                                "plain_keypoints": int(ref.keypoints.valid.sum()), "fields_differing": fields,
                                "finite": finite, "inside": inside, "self_matches": int(m.count().sum()),
                                "launches": launches}
        print(f"{name} ({w}x{h}{', uint8' if img.dtype == np.uint8 else ''}): {n} keypoints through the kernels, "
              f"{int(ref.keypoints.valid.sum())} through the twins, {DEGENERATE_COUNTS[name]} in the JAX package; "
              f"slot for slot {'equal' if not fields else 'DIFFERENT in ' + ', '.join(fields)}; finite {finite}, "
              f"inside the frame {inside}; self-matches {int(m.count().sum())}; launches {launches}", flush=True)
        if fields:
            fail(f"degenerate {name}: the kernels differ from the plain twins in {', '.join(fields)}")
        if n != DEGENERATE_COUNTS[name] or not (finite and inside):
            fail(f"degenerate {name}: {n} keypoints (the JAX package finds {DEGENERATE_COUNTS[name]}), finite "
                 f"{finite}, inside {inside}")
        feats_of[name] = got
    # Empty descriptor sets into kernel 4, in three orders.
    full = feats_of["uint8"]
    k = DEGENERATE_SMALL["max_keypoints"]
    empty = (torch.zeros((1, k, 16), dtype=torch.int32, device=dev), torch.zeros((1, k), dtype=torch.bool, device=dev))
    sets = {"empty": empty, "full": (full.descriptors, full.keypoints.valid)}
    reset_counts()
    for a, b in (("empty", "full"), ("full", "empty"), ("empty", "empty")):
        m = match(*sets[a], *sets[b], mcfg, device=dev)
        mp = match_fn(*sets[a], *sets[b], mcfg, plain=True)
        n = int(m.count().sum())
        res["match"][f"{a}_{b}"] = {"accepted": n, "equal_to_plain": same_matches(m, mp)}
        print(f"match {a} against {b}: {n} accepted, {'equal to' if same_matches(m, mp) else 'DIFFERENT from'} "
              f"the plain twin", flush=True)
        if n != 0 or not same_matches(m, mp):
            fail(f"match {a} against {b}: {n} accepted (0 expected), or the kernel differs from its twin")
    launches = path_launches()
    if launches["match"] != 3:
        fail(f"the empty-set matches launched kernel 4 {launches['match']} times, expected 3")
    for kname in ("base_stage", "fused_octave", "describe", "match"):
        if res["launches"][kname] <= 0:
            fail(f"phase 10a did not launch kernel {kname}")
    # Kernel 2 on a seed with a NaN block and the clean frames' contrast
    # factor, so that the NaN region grows level by level and pixels beside
    # it meet NaN neighbours at every level: fields equal, NaN for NaN.
    imgs = torch.from_numpy(video_sequence(4, 240, 320, seed=4)).to(dev)
    ss, _ = _statics(320, 240, AkazeConfig())
    cfg = ss.config
    k = contrast_factor_from_modg(base_stage_plain(imgs, cfg.base_scale_offset)[1], cfg)
    imgs[1, 100:104, 150:154] = float("nan")
    seed, _ = base_stage_plain(imgs, cfg.base_scale_offset)
    groups, n_nan, n_cand = ss.groups, 0, 0
    for oi, (l0, n, _, _) in enumerate(groups):
        if oi:
            k = k * cfg.contrast_octave_decay
        argv = (seed, k, tuple(ss.specs[l0 : l0 + n]), cfg.diffusivity, oi == 0, float(cfg.detector_threshold),
                oi + 1 < len(groups))
        got, ref = fused_octave(*argv), fused_octave_plain(*argv)
        for fname, g, r in zip(("Lt", "Lx", "Ly", "score", "sub", "half"), got, ref):
            n_diff = 0 if g is None and r is None else int((~((g == r) | (torch.isnan(g) & torch.isnan(r)))).sum())
            if n_diff:
                fail(f"kernel 2 on a NaN seed: octave {oi} {fname} differs from its twin at {n_diff} pixels")
        n_nan += int(torch.isnan(ref[0]).sum())
        n_cand += int((ref[3] > -1e38).sum())
        seed = ref[5]
    print(f"kernel 2 on 4 frames of 320x240 with a 4x4 NaN block in frame 1: {len(groups)} octaves equal to "
          f"fused_octave_plain NaN for NaN (Lt, Lx, Ly, score, sub, half); {n_nan} NaN pixels of Lt, {n_cand} "
          f"candidates", flush=True)
    res["kernel2_nan_seed"] = {"nan_px": n_nan, "candidates": n_cand}
    del feats_of, full, sets, imgs, seed, got, ref
    torch.cuda.empty_cache()

    # ---- b. the NaN pair: the card's RANSAC against the CPU's, on JAX's draws
    print("\n== phase 10b: two-view RANSAC with NaN correspondences, the card against the CPU "
          "(RansacConfig(num_iterations=64), JAX's PRNGKey(0) draws)", flush=True)
    rcfg = RansacConfig(num_iterations=64)
    res["nan_pair"] = {}
    for name, (rows, keep, want) in NAN_PAIR_CASES.items():
        x1, x2, mask = nan_pair_inputs(np)
        x1[rows] = np.nan
        mask[rows] = keep
        draws = jax_uniform(rcfg.seed, (rcfg.num_iterations, len(mask)))
        card = estimate_relative_pose(x1, x2, mask, rcfg, device=dev, sample_scores=draws)
        cpu = estimate_relative_pose(x1, x2, mask, rcfg, device="cpu", sample_scores=draws)
        n_card, n_cpu = int(card.num_inliers), int(cpu.num_inliers)
        R_c, t_c, R_h, t_h = (x.cpu().numpy() for x in (card.R, card.t, cpu.R, cpu.t))
        if want == 0:
            ok = n_card == n_cpu == 0 and np.isnan(t_c).all() and np.isnan(t_h).all()
            d_rot = d_t = None
            detail = f"pose NaN on the card {bool(np.isnan(t_c).all())}, on the CPU {bool(np.isnan(t_h).all())}"
        else:
            d_rot, d_t = rot_deg(np, R_c, R_h), dir_deg(np, t_c, t_h)
            ok = n_card == n_cpu == want and d_rot <= 0.05 and d_t <= 0.2
            detail = f"R {d_rot:.5f} deg, t-direction {d_t:.5f} deg apart; t on the card {np.round(t_c, 6).tolist()}"
        res["nan_pair"][name] = {"inliers_card": n_card, "inliers_cpu": n_cpu, "jax_inliers": want,
                                 "rot_deg": d_rot, "tdir_deg": d_t, "ok": bool(ok)}
        print(f"{name}: inliers {n_card} on the card, {n_cpu} on the CPU, {want} in the JAX package; {detail}",
              flush=True)
        if not ok:
            fail(f"NaN pair {name}: the card's pose differs from the CPU's or from the JAX package's count")

    # ---- c. bench_cuda.py as a user runs it
    torch.cuda.empty_cache()
    cmd = [sys.executable, str(root / "bench_cuda.py"), "--only", "headline,two_view"]
    print(f"\n== phase 10c: {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("bench_cuda.py did not finish within 600 s")
    wall = time.perf_counter() - t0
    lines = {}
    for line in proc.stdout.splitlines():
        print(f"  {line}", flush=True)
        if line.startswith("{"):
            rec = json.loads(line)
            lines[rec["metric"]] = rec
    if proc.returncode != 0:
        fail(f"bench_cuda.py exited {proc.returncode} (the integrity guard raises): {proc.stderr[-2000:]}")
    want = ("baseline_cpu_single_core_fps", "akaze_vga_detect_describe_match_fps", "two_view_pose_pairs_per_s",
            "two_view_rot_err_deg", "two_view_tdir_err_deg")
    for metric in want:
        rec = lines.get(metric)
        if rec is None or not (isinstance(rec["value"], float) and 0.0 < rec["value"] < float("inf")):
            fail(f"bench_cuda.py: {metric} missing or not a finite positive number")
        if rec["baseline_source"] == "literature_fallback" and shutil.which("g++"):
            fail("bench_cuda.py fell back to the literature baseline while g++ is present")
    print(f"bench_cuda.py: {len(lines)} lines in {wall:.1f} s", flush=True)
    res["bench"] = {"wall_s": wall, "lines": [lines[m] for m in want]}
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"kernels launched on phase 10a's paths: {res['launches']}", flush=True)
    print(f"phase 10: {res['phase_s']:.1f} s", flush=True)
    out["degenerate"] = res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    # A rank of phase 8 (started by phase_parallel, not by hand).
    for name in ("--jobs", "--workdir", "--device"):
        ap.add_argument(name, help=argparse.SUPPRESS)
    for name in ("--rank", "--world", "--port"):
        ap.add_argument(name, type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jobs:
        return rank_main(args)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig
        from akaze_tpu_torch.frontend import describe as fdescribe
        from akaze_tpu_torch.frontend.detect import detect, detect_dense, find_candidates_oct
        from akaze_tpu_torch.frontend.pipeline import (
            _statics, extract_batch, extract_batch_fn, extract_fn,
        )
        from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg, half_size
        from akaze_tpu_torch.kernels import _build, contrast
        from akaze_tpu_torch.kernels import fed as fed_kernels
        from akaze_tpu_torch.kernels.describe import describe, describe_plain
        from akaze_tpu_torch.kernels.describe import kernel_occupancy as describe_occupancy
        from akaze_tpu_torch.kernels.describe_single import describe_pallas, describe_pallas_plain
        from akaze_tpu_torch.kernels.fed import (
            base_stage, base_stage_plain, build_scale_space_levels, fused_level_batched,
            fused_level_batched_plain, fused_octave, fused_octave_plain, specs_plan,
            unpack_sub,
        )
        from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain, pair_table
        from akaze_tpu_torch.kernels import topk
        from akaze_tpu_torch.kernels.nms import cross_level_nms, cross_level_nms_plain
        from akaze_tpu_torch.kernels.patch import gather_patches, gather_patches_plain
        from akaze_tpu_torch.matching.hamming import match, match_fn
        from akaze_tpu_torch.utils.profiling import SpanRecorder, record_spans
        from akaze_tpu_torch.utils.synthetic import video_sequence
    except ImportError as e:
        fail(f"the akaze_tpu_torch package is not next to this script ({e})")

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc_version(_build._nvcc())}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build (nvcc, {len(_build.SOURCES)} sources in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, name, regs, st, ld in ptxas_report({src: log for src, (_, log) in built.items()}):
        print(f"  ptxas {src}.cu {name}: {regs} registers, spill stores {st} B, spill loads {ld} B", flush=True)

    B, H, W = args.batch, 480, 640
    config, mcfg = AkazeConfig(), MatchConfig()
    cfg_a = AkazeConfig(describe_backend="xla")  # path A
    ss, ds = _statics(W, H, config)
    groups = ss.groups
    px = B * H * W
    results = {}

    ours = csrc_kernels(root)

    def reset_counts():
        """Zero the wrappers' launch counts and kernels 2 and 5's
        __global__ launch counts."""
        _build.reset_launches()
        for name in fed_kernels.device_launches:
            fed_kernels.device_launches[name] = 0

    def times(fn):
        """The kernel's device time under the profiler and the event time
        around its wrapper."""
        ms, n = kernel_device_ms(torch, ours, fn)
        return {"ms": ms, "global_launches": n, "wrapper_ms": timed(torch, fn)}

    def record(name, **kw):
        t, by = kw["bound"]
        print(f"  {name}: device {kw['ms']:.4f} ms in {kw['global_launches']:.0f} __global__ launches "
              f"(wrapper {kw['wrapper_ms']:.4f} ms), bound {t:.4f} ms "
              f"({by}), plain {kw['plain_ms']:.3f} ms, library "
              f"{'-' if kw.get('library_ms') is None else format(kw['library_ms'], '.3f')} ms", flush=True)
        results[name] = kw

    # ------------------------------------------------------------ phase 2
    print(f"\n== kernels against their plain twins on the card (batch {B} VGA)", flush=True)
    imgs = torch.from_numpy(video_sequence(B, H, W, seed=100)).to(dev)
    sigma0 = float(config.base_scale_offset)

    # Kernel 1, bit for bit (tolerance 0).
    seed_k, modg_k = base_stage(imgs, sigma0)
    seed_p, modg_p = base_stage_plain(imgs, sigma0)
    err1 = max((seed_k - seed_p).abs().max().item(), (modg_k - modg_p).abs().max().item())
    print(f"base_stage   max |err| seed/modg {err1:.3e} (tol 0: bit-equal)", flush=True)
    if not (torch.equal(seed_k, seed_p) and torch.equal(modg_k, modg_p)):
        fail("base_stage differs from its plain twin (bit-equality required)")
    tm1 = times(lambda: base_stage(imgs, sigma0))
    plain_ms = timed(torch, lambda: base_stage_plain(imgs, sigma0), reps=1)
    # 1 plane read, 2 written; ~72 flops/px (sigma0 blur 34, G_1 blur 18,
    # two Scharr 16, magnitude 4).
    bnd = bound_ms(3 * 4 * px, 72 * px)
    record("base_stage", source="akaze_tpu_torch/csrc/fed.cu",
           replaces="akaze_tpu/kernels/fed_pallas.py:440", max_abs_err=err1, **tm1,
           plain_ms=plain_ms, bound=bnd)

    # The contrast factor on kernel 1's planes (equal to the plain twin's),
    # bit for bit, one launch; its row's bound is its design's two reads of
    # the interior planes, its library the plain form.
    tc = contrast_check(torch, modg_k, config, f"batch {B} VGA")
    plain_c = timed(torch, lambda: contrast_factor_from_modg(modg_k, config), reps=1)
    record("contrast", source="akaze_tpu_torch/csrc/contrast.cu", replaces="none (port-only)", max_abs_err=0.0,
           ms=tc["ms"], global_launches=tc["global_launches"],
           wrapper_ms=timed(torch, lambda: contrast.contrast_factor(modg_k, config)), plain_ms=plain_c,
           library_ms=plain_c, bound=bound_ms(2 * 4 * B * (H - 2) * (W - 2), 0))

    # Kernel 2, one entry per octave, each fed the same seed and k.
    k = contrast_factor_from_modg(modg_p, config)
    seed = seed_p
    err2 = 0.0
    tm2 = {"ms": 0.0, "global_launches": 0.0, "wrapper_ms": 0.0}
    plain2 = 0.0
    nbytes2 = nops2 = floor2 = 0.0
    oct_p = []
    for oi, (l0, n, h, w) in enumerate(groups):
        if oi > 0:
            k = k * config.contrast_octave_decay
        specs = tuple(ss.specs[l0 : l0 + n])
        argv = (seed, k, specs, config.diffusivity, oi == 0, float(config.detector_threshold),
                oi + 1 < len(groups))
        got = fused_octave(*argv)
        ref = fused_octave_plain(*argv)
        for name, g, r in zip(("Lt", "Lx", "Ly"), got[:3], ref[:3]):
            e = (g - r).abs().max().item()
            err2 = max(err2, e)
            if not e <= 2e-5:
                fail(f"fused_octave octave {oi} {name} max |err| {e:.3e} > 2e-5")
        cand = ref[3] > -1e38
        if not torch.equal(cand, got[3] > -1e38):
            fail(f"fused_octave octave {oi}: candidate sites differ")
        if not torch.allclose(got[3][cand], ref[3][cand], atol=2e-6, rtol=1e-6):
            fail(f"fused_octave octave {oi}: scores differ beyond atol 2e-6 / rtol 1e-6")
        err2 = max(err2, (got[3][cand] - ref[3][cand]).abs().max().item() if cand.any() else 0.0)
        oxg, oyg, keepg = unpack_sub(got[4])
        oxr, oyr, keepr = unpack_sub(ref[4])
        if not torch.equal(keepg[cand], keepr[cand]):
            fail(f"fused_octave octave {oi}: sub-pixel keep differs at candidates")
        both = cand & keepg
        esub = max((oxg[both] - oxr[both]).abs().max().item(),
                   (oyg[both] - oyr[both]).abs().max().item()) if both.any() else 0.0
        if not esub <= 1e-4:
            fail(f"fused_octave octave {oi}: sub-pixel offsets differ by {esub:.3e} > 1e-4")
        if got[5] is not None:
            e = (got[5] - ref[5]).abs().max().item()
            err2 = max(err2, e)
            if not e <= 2e-5:
                fail(f"fused_octave octave {oi}: half-size seed max |err| {e:.3e} > 2e-5")
        print(f"fused_octave octave {oi} ({h}x{w}, {n} levels, "
              f"{sum(len(s.taus) for s in specs)} FED sweeps): Lt/Lx/Ly/score/half max |err| "
              f"{err2:.3e}, {int(cand.sum())} candidates, sub max |err| {esub:.2e}", flush=True)
        t2 = times(lambda: fused_octave(*argv))
        for key, val in t2.items():
            tm2[key] += val
        print(f"  octave {oi}: device {t2['ms']:.4f} ms, {t2['global_launches']:.0f} __global__ launches "
              "(us: " + ", ".join(f"{name.replace('_kernel', '')} {us:.1f}"
                                  for name, us in launch_times(torch, ours, lambda: fused_octave(*argv))) + ")",
              flush=True)
        plain2 += timed(torch, lambda: fused_octave_plain(*argv), reps=1)
        for li, p in enumerate(specs_plan(specs, h, w, oi == 0, B, sms)):
            print(f"  plan level {l0 + li} ({h}x{w}, {len(specs[li].taus)} sweeps): {p.schedule}, "
                  + "; ".join(f"{x.stage} tile {x.tile[0]}x{x.tile[1]} halo {x.halo} sweeps {x.sweeps} "
                              f"smem {x.smem} B threads {x.threads}" for x in p.launches), flush=True)
        pl = B * h * w
        nbytes2 += 4 * pl * (1 + 5 * n) + (4 * pl // 4 if argv[-1] else 0)
        floor2 += 24 * pl * n
        for li, s in enumerate(specs):
            per_px = 18 + 31 + 35  # first derivatives, second derivatives, score + fit
            if not (oi == 0 and li == 0):
                per_px += 18 + 22 + 17 * len(s.taus)  # G_1 blur, conductivity, sweeps
            nops2 += per_px * pl
        oct_p.append(ref)
        seed = ref[5]
    record("fused_octave", source="akaze_tpu_torch/csrc/fed.cu",
           replaces="akaze_tpu/kernels/fed_pallas.py:365", max_abs_err=err2, **tm2,
           plain_ms=plain2, bound=bound_ms(nbytes2, nops2))
    # The least a design that runs one level at a time moves: per level the
    # previous Lt read, Lt, Lx, Ly, score and sub written (24 B/px).
    print(f"  fused_octave level-at-a-time floor: {floor2 / 1e9:.4f} GB, "
          f"{bound_ms(floor2, 0)[0]:.4f} ms (24 B/px per level)", flush=True)

    # The NMS kernel on the candidates of the plain twins' fields, bit for
    # bit: the survivors' responses, NEG elsewhere.
    lvl_oct = tuple({"Lt": o[0], "Lx": o[1], "Ly": o[2]} for o in oct_p)
    fields = tuple({"score": o[3], "sub": o[4]} for o in oct_p)

    # The per-level top-K kernel on the same score fields, then on 128
    # KITTI frames' (the batch cells' shapes), all leaves bit for bit; the
    # contrast factor on those KITTI frames' modg planes too.
    stacks = [f["score"] for f in fields]
    tk = topk_check(torch, stacks, ss, f"batch {B} VGA")
    tm_topk = times(lambda: topk.per_level_topk(stacks, ss))
    plain_topk = timed(torch, lambda: topk.per_level_topk_plain(stacks, ss), reps=1)
    keys = []  # the int64 keys that the plain form's torch.topk ranks
    for (_, n, h, w), st in zip(groups, stacks):
        bits = st.reshape(n * B, h * w).view(torch.int32).to(torch.int64)
        idx = torch.arange(h * w, device=dev, dtype=torch.int64)
        keys.append((torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF) * (1 << 32) + (h * w - 1 - idx),
                     min(config.per_level_candidates, h * w)))
        del bits
    library_topk = timed(torch, lambda: [torch.topk(key, kk, dim=-1, sorted=True) for key, kk in keys], reps=1)
    del keys
    record("topk", source="akaze_tpu_torch/csrc/topk.cu", replaces="none (port-only)", max_abs_err=0.0,
           **tm_topk, plain_ms=plain_topk, library_ms=library_topk, bound=bound_ms(tk["bytes"], 0))
    ss_kitti, _ = _statics(1241, 376, config)
    imgs_kitti = torch.from_numpy(video_sequence(B, 376, 1241, seed=101)).to(dev)
    topk_check(torch, [f["score"] for f in fed_kernels.build_scale_space(imgs_kitti, ss_kitti)["oct"]], ss_kitti,
               f"batch {B} KITTI 1241x376")
    contrast_check(torch, base_stage(imgs_kitti, sigma0)[1], config, f"batch {B} KITTI 1241x376")
    del imgs_kitti, stacks
    torch.cuda.empty_cache()

    cand = find_candidates_oct(fields, ss)
    masked_k = cross_level_nms(cand, ss)
    keep_p = cross_level_nms_plain(cand, ss)
    masked_p = torch.where(keep_p, cand["resp"], torch.full_like(cand["resp"], fed_kernels.NEG))
    if not torch.equal(masked_k.view(torch.int32), masked_p.view(torch.int32)):
        fail("cross_level_nms differs from its plain form (bit-equality required)")
    nv_l = cand["valid"].sum(-1).double()  # (B, L) valid candidates per level
    L_, K_ = nv_l.shape[1], cand["resp"].shape[-1]
    near = nv_l.clone()
    near[:, 1:] += nv_l[:, :-1]
    near[:, :-1] += nv_l[:, 1:]
    pairs_valid = float((nv_l * near).sum().item())
    pairs_dense = B * K_ * K_ * (3 * L_ - 2)
    print(f"cross_level_nms {int(nv_l.sum())} valid of {cand['valid'].numel()} slots, "
          f"{int((cand['valid'] & ~keep_p).sum())} suppressed: masked responses bit-equal; "
          f"{pairs_valid / 1e6:.3f} M pair tests between valid slots ({pairs_dense / 1e6:.1f} M in the dense form)",
          flush=True)
    tm_nms = times(lambda: cross_level_nms(cand, ss))
    plain_nms = timed(torch, lambda: cross_level_nms_plain(cand, ss), reps=1)
    # Bytes: every slot's valid flag (1 B) read and its masked response
    # (4 B) written, a valid slot's resp, xi, yi and flat (4 B each) read;
    # operations: 8 per pair test (two differences, two squares, a sum, the
    # radius and the response compares) between valid slots of a level and
    # its neighbours.
    nbytes = 5 * cand["valid"].numel() + 16 * float(nv_l.sum().item())
    record("nms", source="akaze_tpu_torch/csrc/nms.cu", replaces="none (port-only)", max_abs_err=0.0,
           **tm_nms, plain_ms=plain_nms, bound=bound_ms(nbytes, 8 * pairs_valid))
    print(f"  nms bound on the dense form's pair tests: {bound_ms(0, 8 * pairs_dense)[0]:.4f} ms", flush=True)
    del cand, masked_k, keep_p, masked_p

    # Kernel 3 on the plain twins' stacks and keypoints.
    kps = detect(find_candidates_oct(fields, ss), fields, ss)
    ang_k, desc_k = describe(kps, lvl_oct, ss, ds)
    ang_p, desc_p = describe_plain(kps, lvl_oct, ss, ds)
    v = kps.valid
    err3 = (ang_k - ang_p).abs().max().item()
    nbad = int((desc_k != desc_p).any(dim=-1).sum())
    print(f"describe     {int(v.sum())} valid of {v.numel()} slots: angle max |err| {err3:.3e} rad, "
          f"{nbad} descriptors differ (tol: bit-equal)", flush=True)
    if not (torch.equal(ang_k, ang_p) and torch.equal(desc_k, desc_p)):
        fail("describe differs from its plain twin (bit-equality required)")
    if (desc_k[~v] != 0).any() or (ang_k[~v] != 0).any():
        fail("describe wrote non-zero output to invalid slots")
    occ = describe_occupancy(dev)
    print(f"  describe_kernel: {occ['threads']} threads per block, {occ['blocks_per_sm']} resident blocks per "
          f"SM x {occ['sms']} SMs (the default grid), {occ['smem_bytes']} B static shared memory, "
          f"{occ['registers']} registers per thread", flush=True)
    tm3 = times(lambda: describe(kps, lvl_oct, ss, ds))
    plain3 = timed(torch, lambda: describe_plain(kps, lvl_oct, ss, ds), reps=1)
    nv = int(v.sum())
    n_samples = 2 * len(ds.ori_di) + 3 * ds.n_samples
    # Valid slots read their samples; every slot reads x, y, class_id and
    # valid (13 B) and writes angle + 16 words.  ~31 kflop per valid slot
    # (orientation 3.3k, windows 13.7k, M-LDB sampling 6.2k, cell means
    # 7.4k, bits 0.5k).
    nbytes3 = 4 * nv * n_samples + v.numel() * (13 + 4 * 17)
    record("describe", source="akaze_tpu_torch/csrc/describe.cu",
           replaces="akaze_tpu/kernels/describe_fused.py:562", max_abs_err=err3, **tm3,
           plain_ms=plain3, bound=bound_ms(nbytes3, 31_000 * nv))

    # Kernel 4 on consecutive pairs of the plain descriptors.
    da, va = desc_p[:-1].contiguous(), v[:-1].contiguous()
    db, vb = desc_p[1:].contiguous(), v[1:].contiguous()
    got = match_reduce(da, va, db, vb)
    ref = match_reduce_plain(da, va, db, vb)
    for name, g, r in zip(("best", "second", "nn", "colmin", "colarg"), got, ref):
        if not torch.equal(g, r):
            fail(f"match_reduce {name} differs from its plain twin (exact equality required)")
    print(f"match_reduce {B - 1} pairs: all five vectors exactly equal", flush=True)
    tm4 = times(lambda: match_reduce(da, va, db, vb))
    # The profiler has seen 2 of kernel 4's 3 __global__ launches in some
    # runs: its device time is taken by CUDA events around 50 back-to-back
    # calls instead (the host enqueues a call faster than the card runs it).
    prof4 = tm4["ms"]
    tm4["ms"] = back_to_back_ms(torch, lambda: match_reduce(da, va, db, vb))
    print(f"  match_reduce: {tm4['ms']:.4f} ms per call by CUDA events over 50 back-to-back calls (the profiler "
          f"read {prof4:.4f} ms in {tm4['global_launches']:.0f} __global__ launches per call)", flush=True)
    plain4 = timed(torch, lambda: match_reduce_plain(da, va, db, vb), reps=1)
    # Its work: every distance an output depends on, per pair Ka * n_vb (each
    # row over the B-valid columns) + n_va * Kb (each column over the A-valid
    # rows) - n_va * n_vb (counted twice), each 1,024 operations on the int8
    # tensor cores (512 one-bit multiply-adds); bytes: descriptors and masks
    # read, five int32 vectors written.
    ka4, kb4 = da.shape[1], db.shape[1]
    na, nb = va.sum(1).double(), vb.sum(1).double()
    n_dist = float((ka4 * nb + na * kb4 - na * nb).sum().item())
    bytes4 = 4 * (da.numel() + db.numel()) + va.numel() + vb.numel() + 4 * (3 * va.numel() + 2 * vb.numel())
    print(f"  match_reduce: {n_dist / 1e6:.3f} M distances; as 32-bit popcounts at the popcount peak "
          f"{16 * n_dist / POPC_OPS_PER_S * 1e3:.4f} ms", flush=True)
    record("match", source="akaze_tpu_torch/csrc/match.cu",
           replaces="akaze_tpu/kernels/match_pallas.py:95", max_abs_err=0.0, **tm4,
           plain_ms=plain4, bound=bound_ms(bytes4, 1024 * n_dist, INT8_OPS_PER_S))

    # Kernel 4 over a pair table: the batch as one set of views, every pair
    # i < j of its first 16 frames (and a view against itself) read through
    # the table in one launch, bit-equal to the plain twin over the same
    # table and to the kernel over the gathered (P, K, 16) copies; `match`
    # over the same table is one launch per call and equals its plain twin.
    views = min(B, 16)
    pair_list = [(i, j) for i in range(views) for j in range(i + 1, views)] + [(views - 1, views - 1)]
    host_table = torch.tensor(pair_list, dtype=torch.int32)
    sa, sv = desc_p.contiguous(), v.contiguous()
    table = pair_table(host_table, B, B, dev)
    ta, tb = table[:, 0].long(), table[:, 1].long()
    gathered = match_reduce(sa[ta].contiguous(), sv[ta].contiguous(), sa[tb].contiguous(), sv[tb].contiguous())
    plain = match_reduce_plain(sa, sv, sa, sv, host_table)
    before = _build.launches["match"]
    got = match_reduce(sa, sv, sa, sv, table)
    torch.cuda.synchronize()
    if _build.launches["match"] != before + 1:
        fail(f"match_reduce over a pair table launched kernel 4 {_build.launches['match'] - before} times, expected 1")
    for name, g, r, q in zip(("best", "second", "nn", "colmin", "colarg"), got, plain, gathered):
        if not torch.equal(g, r):
            fail(f"match_reduce over a pair table: {name} differs from its plain twin (exact equality required)")
        if not torch.equal(g, q):
            fail(f"match_reduce over a pair table: {name} differs from the gathered form (exact equality required)")
    before = _build.launches["match"]
    m_table = match(sa, sv, sa, sv, mcfg, device=dev, pairs=host_table)
    torch.cuda.synchronize()
    if _build.launches["match"] != before + 1:
        fail(f"match over a pair table launched kernel 4 {_build.launches['match'] - before} times, expected 1")
    m_plain = match_fn(sa, sv, sa, sv, mcfg, plain=True, pairs=host_table)
    m_gathered = match_fn(sa[ta].contiguous(), sv[ta].contiguous(), sa[tb].contiguous(), sv[tb].contiguous(), mcfg)
    for other, what in ((m_plain, "its plain twin"), (m_gathered, "the gathered form")):
        if not all(torch.equal(getattr(m_table, k), getattr(other, k)) for k in ("idx_b", "distance", "accepted")):
            fail(f"match over a pair table differs from {what}")
    print(f"match_reduce over a pair table, {len(pair_list)} pairs of {views} views: all five vectors equal to the "
          f"plain twin over the table and to the gathered form, one launch; match over the table: "
          f"{int(m_table.count().sum())} accepted, equal to its plain twin, one launch", flush=True)

    # Kernel 7 on the live chunks of path A's describe at this batch: the
    # per-octave planes restacked and the chunk slots cut as the chunked
    # describe cuts them.  It copies, so it must equal its twin bit for bit.
    _, ds_a = _statics(W, H, cfg_a)
    stacks_a = fdescribe.restack_levels(lvl_oct, ss)
    slots, live = fdescribe.chunk_slots(kps, ds_a)
    f7 = {key: val[live].reshape(-1) for key, val in slots.items()}
    geo = fdescribe.chunk_geometry(f7["x"], f7["y"], f7["class_id"], ss, ds_a)
    ph, pw = ds_a.ph, ds_a.pw
    argv7 = (stacks_a, f7["frame"], geo["lvl"], geo["y0"], geo["x0"], f7["valid"], ph, pw)
    got7 = gather_patches(*argv7)
    if not torch.equal(got7, gather_patches_plain(*argv7)):
        fail("gather_patches differs from its plain twin (exact equality required)")
    n7, nv7 = f7["valid"].numel(), int(f7["valid"].sum())
    print(f"gather_patches {live.numel()} live chunks, {n7} slots ({nv7} valid) of 3 x {ph}x{pw}: "
          f"equal to its plain twin bit for bit", flush=True)
    tm7 = times(lambda: gather_patches(*argv7))
    plain7 = timed(torch, lambda: gather_patches_plain(*argv7), reps=1)
    # The yardstick: one advanced-indexing call cutting the same windows
    # from one (3, L, B, H0, W0) stack with broadcast index tensors.
    s3 = torch.stack([stacks_a[key] for key in ("Lt", "Lx", "Ly")])
    idx7 = (torch.arange(3, device=dev)[None, :, None, None], geo["lvl"].long()[:, None, None, None],
            f7["frame"].long()[:, None, None, None],
            (geo["y0"].long()[:, None] + torch.arange(ph, device=dev))[:, None, :, None],
            (geo["x0"].long()[:, None] + torch.arange(pw, device=dev))[:, None, None, :])
    if not torch.equal(s3[idx7][f7["valid"]], got7[f7["valid"]]):
        fail("the advanced-indexing yardstick cuts other windows than gather_patches")
    lib7 = timed(torch, lambda: s3[idx7])
    # Bytes: the windows of valid slots overlap (a deep level's windows all
    # lie in one 64 x 80 region of each frame), so the reads are the union
    # of the windows over the (L, B, H0, W0) stacks, 3 channels; every slot
    # writes its 3 x ph x pw window and reads 5 index words.
    v7 = f7["valid"]
    cover = torch.zeros(s3.shape[1:], dtype=torch.bool, device=dev)
    cover[geo["lvl"].long()[v7][:, None, None], f7["frame"].long()[v7][:, None, None],
          (geo["y0"].long()[v7][:, None] + torch.arange(ph, device=dev))[:, :, None],
          (geo["x0"].long()[v7][:, None] + torch.arange(pw, device=dev))[:, None, :]] = True
    read7 = int(cover.sum()) * 3 * 4
    print(f"  gather_patches reads {read7 / 1e9:.4f} GB (the union of the windows; "
          f"{nv7 * 3 * ph * pw * 4 / 1e9:.4f} GB counted window by window)", flush=True)
    del cover
    record("gather_patches", source="akaze_tpu_torch/csrc/patch.cu",
           replaces="akaze_tpu/kernels/patch_pallas.py:173", max_abs_err=0.0, **tm7, plain_ms=plain7,
           library_ms=lib7, bound=bound_ms(read7 + n7 * 3 * ph * pw * 4 + 5 * 4 * n7, 0))
    del imgs, seed_k, modg_k, seed_p, modg_p, oct_p, lvl_oct, fields, kps, got, ref, stacks_a, s3, got7
    torch.cuda.empty_cache()

    # Kernels 5 and 6 on single VGA frames, path B's shapes.
    frames5 = torch.from_numpy(video_sequence(4, H, W, seed=200)).to(dev)
    print(f"\n== kernels 5 and 6 against their plain twins on the card ({W}x{H} frames)", flush=True)
    # Kernel 5 on all levels of 4 frames, each level fed the plain chain's seed.
    seed5, modg5 = base_stage_plain(frames5, sigma0)
    k5 = contrast_factor_from_modg(modg5, config)
    argv5, err5 = [], 0.0
    for i, spec in enumerate(ss.specs):
        if i > 0 and spec.octave > ss.specs[i - 1].octave:
            seed5, k5 = half_size(seed5).contiguous(), k5 * config.contrast_octave_decay
        a5 = (seed5, k5, spec, config.diffusivity, i == 0)
        got = fused_level_batched(*a5)
        ref = fused_level_batched_plain(*a5)
        for name, g, r in zip(("Lt", "Lx", "Ly", "Ldet"), got, ref):
            e = (g - r).abs().max().item()
            err5 = max(err5, e)
            if not e <= 2e-5:
                fail(f"fused_level level {i} {name} max |err| {e:.3e} > 2e-5")
        argv5.append(a5)
        seed5 = ref[0]
    print(f"fused_level  {len(argv5)} levels x 4 frames: Lt/Lx/Ly/Ldet max |err| {err5:.3e} (tol 2e-5)",
          flush=True)
    one5 = [(a[0][:1].contiguous(), a[1][:1].contiguous(), *a[2:]) for a in argv5]
    tm5 = times(lambda: [fused_level_batched(*a) for a in one5])
    print("  fused_level device us by level and launch: " + "; ".join(
        " ".join(f"{us:.1f}" for _, us in launch_times(torch, ours, lambda a=a: fused_level_batched(*a)))
        for a in one5), flush=True)
    plain5 = timed(torch, lambda: [fused_level_batched_plain(*a) for a in one5], reps=1)
    px5 = [sp.width * sp.height for sp in ss.specs]
    # Per level: seed read, 4 planes written; first derivatives 18 and
    # second 31 flops/px, plus G_1 blur 18, conductivity 22 and 17 per FED
    # sweep past level 0.
    ops5 = sum(p * (49 + (0 if i == 0 else 40 + 17 * len(sp.taus)))
               for i, (p, sp) in enumerate(zip(px5, ss.specs)))
    record("fused_level", source="akaze_tpu_torch/csrc/fed.cu",
           replaces="akaze_tpu/kernels/fed_pallas.py:240", max_abs_err=err5, **tm5, plain_ms=plain5,
           bound=bound_ms(5 * 4 * sum(px5), ops5))

    # Kernel 6 on the per-level path's keypoints of each of the 4 frames.
    st6 = build_scale_space_levels(frames5, ss, plain=True)
    kps6 = detect_dense(st6["Ldet"], ss)
    err6, n6, argv6 = 0.0, 0, []
    for f in range(4):
        kp = kps6.index(f)
        stacks6 = {key: st6[key][f] for key in ("Lt", "Lx", "Ly")}
        a6 = (kp, stacks6, ss, ds)
        ang_k, desc_k = describe_pallas(*a6)
        ang_p, desc_p = describe_pallas_plain(*a6)
        v = kp.valid
        err6 = max(err6, (ang_k - ang_p).abs().max().item())
        n6 += int(v.sum())
        if not (torch.equal(ang_k, ang_p) and torch.equal(desc_k, desc_p)):
            fail(f"describe_pallas frame {f}: differs from its plain twin (bit-equality required)")
        if (ang_k[~v] != 0).any() or (desc_k[~v] != 0).any():
            fail("describe_pallas wrote non-zero output to an invalid slot")
        argv6.append(a6)
    print(f"describe_pallas {n6} valid slots in 4 frames: angles and descriptors bit-equal", flush=True)
    tm6 = times(lambda: describe_pallas(*argv6[0]))
    plain6 = timed(torch, lambda: describe_pallas_plain(*argv6[0]), reps=1)
    nv6 = int(argv6[0][0].valid.sum())
    # As kernel 3: valid slots read their samples, every slot its fields
    # (13 B) and writes its 17 output words.
    record("describe_pallas", source="akaze_tpu_torch/csrc/describe.cu",
           replaces="akaze_tpu/kernels/describe_pallas.py:350", max_abs_err=err6, **tm6, plain_ms=plain6,
           bound=bound_ms(4 * nv6 * n_samples + config.max_keypoints * (13 + 4 * 17), 31_000 * nv6))
    del frames5, seed5, modg5, argv5, one5, st6, kps6, argv6, got, ref
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 3
    frame_sets = [torch.from_numpy(video_sequence(B, H, W, seed=s)).to(dev)
                  for s in range(args.reps + 1)]

    def run_batches(cfg, title):
        """1 warm-up + reps timed passes of extract_batch + match on distinct
        batches, launch counts zeroed just before and read just after."""
        print(f"\n== {title}: extract_batch + consecutive match, batch {B} x {W}x{H}", flush=True)
        torch.cuda.synchronize()
        reset_counts()
        pass_ms, kp_counts, match_counts = [], [], []
        for i, frames in enumerate(frame_sets):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            feats = extract_batch(frames, cfg)
            kp = feats.keypoints
            m = match(*_pairs(feats), mcfg)
            b.record()
            torch.cuda.synchronize()
            if i > 0:
                pass_ms.append(a.elapsed_time(b))
            kp_counts.append(kp.count().cpu())
            match_counts.append(m.count().cpu())
            if not (torch.isfinite(kp.x[kp.valid]).all() and torch.isfinite(kp.angle).all()):
                fail("non-finite keypoint output")
            if feats.descriptors.shape != (B, cfg.max_keypoints, 16) or kp.x.shape != (B, cfg.max_keypoints):
                fail(f"unexpected output shapes {tuple(feats.descriptors.shape)}")
        counts = dict(_build.launches)
        fps = [B / (t / 1e3) for t in pass_ms]
        print(f"passes (ms): {[round(t, 3) for t in pass_ms]}  frames/s: {[round(f, 1) for f in fps]}",
              flush=True)
        print(f"frames/s mean {sum(fps) / len(fps):.1f}, best {max(fps):.1f}", flush=True)
        fps_of[title] = (sum(fps) / len(fps), max(fps))
        kc = torch.stack(kp_counts).double()
        mc = torch.stack(match_counts).double()
        print(f"keypoints/frame mean {kc.mean().item():.1f}, accepted matches/pair mean "
              f"{mc.mean().item():.1f}", flush=True)
        print(f"kernels launched over {len(frame_sets)} batches: {counts}; __global__ launches of "
              f"the level chain: {dict(fed_kernels.device_launches)}", flush=True)
        if len({int(c.sum()) for c in kp_counts}) < 2:
            fail("distinct inputs gave identical keypoint counts")
        if kc.min() <= 0:
            fail("a frame produced no keypoints")
        return counts

    n_batches = len(frame_sets)
    fps_of = {}
    launches = run_batches(config, "main path")
    expect = {"base_stage": 1, "fused_octave": len(groups), "describe": 1, "match": 1, "nms": 1, "topk": 1,
              "contrast": 1}
    for name, per in expect.items():
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path")
        if launches[name] != per * n_batches:
            fail(f"{name}: {launches[name]} launches, expected {per} per batch")

    # Stage breakdown of one batch: the spans of a real extract_batch + match call.
    def stage_spans(cfg):
        with record_spans(SpanRecorder()) as rec:
            match(*_pairs(extract_batch(frame_sets[0], cfg)), mcfg)
        torch.cuda.synchronize()
        return rec

    spans = stage_spans(config)
    for name in STAGE_SPANS:
        print(f"  span {name}: {spans.ms(name):.3f} ms", flush=True)
    print(f"  scale space less the contrast factor (self): {spans.self_ms('frontend.scale_space'):.3f} ms", flush=True)
    profile_step(torch, ours, "batch", lambda: match(*_pairs(extract_batch(frame_sets[1], config)), mcfg))

    # Path A: the same batches through the chunked describe (kernel 7).
    launches_a = run_batches(cfg_a, "path A, describe_backend='xla'")
    for name in ("base_stage", "fused_octave", "gather_patches", "match"):
        if launches_a[name] <= 0:
            fail(f"kernel {name} was not launched by path A")
    if launches_a["describe"] != 0:
        fail("path A launched the fused describe kernel")
    print(f"  span frontend.describe (restack + kernel 7 + chunked describe): "
          f"{stage_spans(cfg_a).ms('frontend.describe'):.3f} ms (the fused describe: "
          f"{spans.ms('frontend.describe'):.3f} ms above)", flush=True)
    del frame_sets
    torch.cuda.empty_cache()

    # Path B: extract_fn on single VGA frames (kernels 1, 5 and 7), 1
    # warm-up and 8 timed frames, all distinct.
    print(f"\n== path B: extract_fn on single {W}x{H} frames", flush=True)
    frames_b = torch.from_numpy(video_sequence(9, H, W, seed=1)).to(dev)
    torch.cuda.synchronize()
    reset_counts()
    ms_b, n_b = [], []
    for i in range(len(frames_b)):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fb = extract_fn(frames_b[i], config)
        b.record()
        torch.cuda.synchronize()
        if i > 0:
            ms_b.append(a.elapsed_time(b))
        n_b.append(int(fb.keypoints.count()))
        if not (torch.isfinite(fb.keypoints.x[fb.keypoints.valid]).all() and n_b[-1] > 0):
            fail("path B: no or non-finite keypoints")
        if fb.descriptors.shape != (config.max_keypoints, 16):
            fail(f"path B: unexpected descriptor shape {tuple(fb.descriptors.shape)}")
    launches_b = dict(_build.launches)
    print(f"ms per frame: {[round(t, 3) for t in ms_b]}  mean {sum(ms_b) / len(ms_b):.3f} "
          f"({1e3 * len(ms_b) / sum(ms_b):.1f} frames/s), keypoints/frame {n_b}", flush=True)
    print(f"kernels launched over {len(frames_b)} frames: {launches_b}; __global__ launches of "
          f"the level chain: {dict(fed_kernels.device_launches)}", flush=True)
    for name, per in (("base_stage", 1), ("fused_level", ss.num_levels), ("gather_patches", 1)):
        if launches_b[name] < per * len(frames_b):
            fail(f"path B: {name} launched {launches_b[name]} times, expected {per} per frame")
    profile_step(torch, ours, "path-B frame", lambda: extract_fn(frames_b[1], config))

    # describe(backend="pallas") (kernel 6) on the same frames.
    inputs_b = []
    for i in range(len(frames_b)):
        st_b = build_scale_space_levels(frames_b[i : i + 1], ss)
        inputs_b.append((detect_dense(st_b["Ldet"], ss).index(0),
                         {key: st_b[key][0] for key in ("Lt", "Lx", "Ly")}))
    torch.cuda.synchronize()
    reset_counts()
    ms_6 = []
    for i, (kp, stacks) in enumerate(inputs_b):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fd = fdescribe.describe(kp, stacks, ss, ds, backend="pallas")
        b.record()
        torch.cuda.synchronize()
        if i > 0:
            ms_6.append(a.elapsed_time(b))
        if (fd.descriptors[~kp.valid] != 0).any() or not (fd.descriptors[kp.valid] != 0).any(dim=-1).all():
            fail("describe(backend='pallas'): zero descriptor at a valid slot or non-zero at an invalid one")
    launches_6 = dict(_build.launches)
    print(f"describe(backend='pallas') ms per frame: {[round(t, 3) for t in ms_6]}  mean "
          f"{sum(ms_6) / len(ms_6):.3f}; launches {launches_6['describe_pallas']}", flush=True)
    if launches_6["describe_pallas"] != len(inputs_b):
        fail("describe(backend='pallas') did not launch kernel 6 once per frame")
    launches.update(gather_patches=launches_a["gather_patches"], fused_level=launches_b["fused_level"],
                    describe_pallas=launches_6["describe_pallas"])
    del frames_b, inputs_b, fb, fd
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 4
    print("\n== whole path at batch 2: kernels against the plain twins, on the card", flush=True)
    small = torch.from_numpy(video_sequence(2, H, W, seed=7)).to(dev)
    fk = extract_batch_fn(small, config)
    fp = extract_batch_fn(small, config, plain=True)
    mk = match_fn(fk.descriptors[:-1], fk.keypoints.valid[:-1], fk.descriptors[1:], fk.keypoints.valid[1:], mcfg)
    mp = match_fn(fp.descriptors[:-1], fp.keypoints.valid[:-1], fp.descriptors[1:], fp.keypoints.valid[1:],
                  mcfg, plain=True)
    for f in range(2):
        ck, cp = int(fk.keypoints.valid[f].sum()), int(fp.keypoints.valid[f].sum())
        if abs(ck - cp) > max(2, 0.02 * cp):
            fail(f"frame {f}: {ck} keypoints through the kernels, {cp} through the plain twins")
        vk = fk.keypoints.valid[f].cpu().numpy()
        vp = np.nonzero(fp.keypoints.valid[f].cpu().numpy())[0]
        kx, ky, kc_ = (getattr(fk.keypoints, a)[f].cpu().numpy() for a in ("x", "y", "class_id"))
        px_, py_, pc_ = (getattr(fp.keypoints, a)[f].cpu().numpy() for a in ("x", "y", "class_id"))
        dk = fk.descriptors[f].cpu().numpy()
        dp = fp.descriptors[f].cpu().numpy()
        paired, hams = 0, []
        for i in vp:
            c = np.nonzero(vk & (kc_ == pc_[i]))[0]
            if len(c) == 0:
                continue
            dist = np.hypot(kx[c] - px_[i], ky[c] - py_[i])
            if dist.min() < 0.01:
                paired += 1
                hams.append(int(hamming(np, dk[c[dist.argmin()]], dp[i])))
        frac = paired / max(1, len(vp))
        print(f"frame {f}: {ck} / {cp} keypoints, {frac:.4f} paired within 0.01 px, "
              f"Hamming mean {np.mean(hams):.3f}", flush=True)
        if frac < 0.98 or np.mean(hams) > 3:
            fail(f"frame {f}: the kernel path misses the slice gates against the plain path")
    ak, ap = int(mk.count().sum()), int(mp.count().sum())
    print(f"accepted matches: {ak} through the kernels, {ap} through the plain twins", flush=True)
    if abs(ak - ap) > 0.05 * max(ap, 1):
        fail("accepted matches differ by more than 5 %")

    # Paths A and B through the kernels equal the paths through the twins.
    print("\n== paths A (batch 2) and B (one frame): kernels against the plain twins, on the card", flush=True)
    pairs = (("path A", extract_batch_fn(small, cfg_a), extract_batch_fn(small, cfg_a, plain=True)),
             ("path B", extract_fn(small[0], config), extract_fn(small[0], config, plain=True)))
    for name, fk, fp in pairs:
        same = (torch.equal(fk.keypoints.valid, fp.keypoints.valid) and torch.equal(fk.keypoints.x, fp.keypoints.x)
                and torch.equal(fk.keypoints.y, fp.keypoints.y) and torch.equal(fk.descriptors, fp.descriptors))
        print(f"{name}: {fk.keypoints.count().tolist()} / {fp.keypoints.count().tolist()} keypoints, "
              f"keypoints and descriptors {'equal' if same else 'DIFFERENT'}", flush=True)
        if not same:
            fail(f"{name} through the kernels differs from the plain twins")

    del small, fk, fp, mk, mp, pairs
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phases 5-6
    sequence = {}
    phase_video(torch, np, dev, reset_counts, sequence)
    phase_two_view(torch, np, dev, reset_counts, sequence)
    phase_stills(torch, np, dev, reset_counts, sequence)
    print(json.dumps({"sequence_two_view": sequence}), flush=True)

    # ------------------------------------------------------------ phase 7
    sfm, kept = {}, {}
    phase_sfm(torch, np, dev, reset_counts, sfm, kept)
    print(json.dumps(sfm), flush=True)
    sfm_launches = sfm["sfm"]["cli"]["launches"]

    # ------------------------------------------------------------ phase 8
    parallel = {}
    phase_parallel(torch, np, dev, kept, parallel)
    print(json.dumps(parallel), flush=True)

    # ------------------------------------------------------------ phase 9
    oracles = {}
    phase_oracles(torch, np, dev, root, card, reset_counts, *fps_of["main path"], oracles)
    print(json.dumps(oracles), flush=True)

    # ------------------------------------------------------------ phase 10
    degenerate = {}
    phase_degenerate(torch, np, dev, root, reset_counts, degenerate)
    print(json.dumps(degenerate), flush=True)

    # The level chain's launch structure: __global__ launches and device
    # time under the profiler (phase 2's rows).
    print(f"level chain: fused_octave per batch-{B} VGA {results['fused_octave']['global_launches']:.0f} "
          f"__global__ launches, {results['fused_octave']['ms']:.4f} ms device; fused_level per VGA frame "
          f"{results['fused_level']['global_launches']:.0f} launches, {results['fused_level']['ms']:.4f} ms "
          f"device ({results['fused_level']['wrapper_ms']:.4f} ms around its {ss.num_levels} wrapper calls)",
          flush=True)
    kernels = []
    for name, r in results.items():
        t, by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": t, "bound_by": by, "library_ms": r.get("library_ms"),
            "wrapper_ms": r["wrapper_ms"], "global_launches": r["global_launches"],
            "video_launches": sequence["video"]["launches"].get(name, 0),
            "two_view_launches": sequence["two_view"]["launches"].get(name, 0),
            "stills_launches": sequence["stills"]["launches"].get(name, 0),
            "sfm_cli_launches": sfm_launches.get(name, 0),
            "parallel_launches": parallel["parallel"]["launches"].get(name, 0),
            "oracle_launches": oracles["oracles"]["launches"].get(name, 0),
            "degenerate_launches": degenerate["degenerate"]["launches"].get(name, 0),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # nvidia-smi's name and power limit, as it prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
