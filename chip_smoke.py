#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akaze_tpu_torch) on one GPU.

    python3 chip_smoke.py [--batch 128] [--reps 3]

1. Prints the card (nvidia-smi name and power limit), the torch / CUDA /
   nvcc versions, and builds the four kernels from akaze_tpu_torch/csrc
   (all nvcc processes in parallel), timing the build.
2. Holds each kernel against its plain PyTorch twin on the card, on the
   main path's inputs (batch VGA frames), with the stated tolerances, and
   times both.
3. Drives the main path through its public entry points at full width:
   extract_batch on batch x 640x480 frames with the default AkazeConfig,
   then consecutive-pair match with the default MatchConfig; 1 warm-up and
   `reps` timed passes on distinct inputs.  Launch counts are zeroed just
   before and read just after; every kernel must have launched.
   One more batch runs under torch.profiler: device time by kernel, split
   into the kernels of akaze_tpu_torch/csrc and PyTorch ops, and the
   device's idle share of that profiled batch.
4. Runs the whole path at batch 2 through the kernels and through the plain
   twins, both on the card, and holds them to the slice gates.

Prints a JSON line of per-kernel numbers, the card line, and last
{"ok": true, "device": {...}}.  Exits non-zero without a result when no
GPU is present, when the package is missing, or when any check fails.
"""

from __future__ import annotations

import argparse
import json
import math
import re
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
    """Median device time (ms) of fn() over reps runs, after one warm-up."""
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


def bound_ms(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pairs(feats):
    """Consecutive-pair match arguments of a batch of Features."""
    d, v = feats.descriptors, feats.keypoints.valid
    return d[:-1], v[:-1], d[1:], v[1:]


def profile_batch(torch, root: Path, step) -> None:
    """Run step() once under torch.profiler and print its device time by
    kernel: the __global__ functions of akaze_tpu_torch/csrc against
    PyTorch's ops, and the idle share of the profiled batch."""
    from torch.profiler import ProfilerActivity, profile

    ours = set()
    for src in sorted((root / "akaze_tpu_torch" / "csrc").glob("*.cu")):
        ours.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                               src.read_text()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: the aten operator rows carry the same time again.
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not busy_ms:
        print(f"profiled batch: wall {wall_ms:.3f} ms, device time not measured (the profiler saw none)",
              flush=True)
        return
    mine = sum(t for t, _, name in rows if name.split("(")[0] in ours)
    print(f"profiled batch: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (under the profiler); {mine:.3f} ms in the "
          f"{len(ours)} kernels of akaze_tpu_torch/csrc, {busy_ms - mine:.3f} ms in PyTorch ops",
          flush=True)
    for t, n, name in rows[:20]:
        print(f"  {t:10.3f} ms {n:6d} calls  {name[:100]}", flush=True)


def hamming(np, a, b):
    return np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum(-1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig
        from akaze_tpu_torch.frontend.detect import detect, find_candidates_oct
        from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn
        from akaze_tpu_torch.frontend.scale_space import contrast_factor_from_modg
        from akaze_tpu_torch.kernels import _build
        from akaze_tpu_torch.kernels.describe import describe, describe_plain
        from akaze_tpu_torch.kernels.fed import (
            base_stage, base_stage_plain, fused_octave, fused_octave_plain, octave_groups,
            unpack_sub,
        )
        from akaze_tpu_torch.kernels.match import match_reduce, match_reduce_plain
        from akaze_tpu_torch.matching.hamming import match, match_fn
        from akaze_tpu_torch.utils.synthetic import video_sequence
    except ImportError as e:
        fail(f"the akaze_tpu_torch package is not next to this script ({e})")

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc_version(_build._nvcc())}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernel build (nvcc, {len(_build.SOURCES)} sources in parallel): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    B, H, W = args.batch, 480, 640
    config, mcfg = AkazeConfig(), MatchConfig()
    ss, ds = _statics(W, H, config)
    groups = octave_groups(ss)
    px = B * H * W
    results = {}

    def record(name, **kw):
        results[name] = kw

    # ------------------------------------------------------------ phase 2
    print(f"\n== kernels against their plain twins on the card (batch {B} VGA)", flush=True)
    imgs = torch.from_numpy(video_sequence(B, H, W, seed=100)).to(dev)
    sigma0 = float(config.base_scale_offset)

    # Kernel 1.  Tolerance 2e-5: the JAX package's scale-space gate.
    seed_k, modg_k = base_stage(imgs, sigma0)
    seed_p, modg_p = base_stage_plain(imgs, sigma0)
    err1 = max((seed_k - seed_p).abs().max().item(), (modg_k - modg_p).abs().max().item())
    print(f"base_stage   max |err| seed/modg {err1:.3e} (tol 2e-5)", flush=True)
    if not err1 <= 2e-5:
        fail("base_stage disagrees with its plain twin")
    ms = timed(torch, lambda: base_stage(imgs, sigma0))
    plain_ms = timed(torch, lambda: base_stage_plain(imgs, sigma0), reps=1)
    # 1 plane read, 2 written; ~72 flops/px (sigma0 blur 34, G_1 blur 18,
    # two Scharr 16, magnitude 4).
    bnd = bound_ms(3 * 4 * px, 72 * px)
    record("base_stage", source="akaze_tpu_torch/csrc/fed.cu",
           replaces="akaze_tpu/kernels/fed_pallas.py:440", max_abs_err=err1, ms=ms,
           plain_ms=plain_ms, bound=bnd)

    # Kernel 2, one entry per octave, each fed the same seed and k.
    k = contrast_factor_from_modg(modg_p, config)
    seed = seed_p
    err2 = 0.0
    ms2 = plain2 = 0.0
    nbytes2 = nops2 = 0.0
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
        ms2 += timed(torch, lambda: fused_octave(*argv))
        plain2 += timed(torch, lambda: fused_octave_plain(*argv), reps=1)
        pl = B * h * w
        nbytes2 += 4 * pl * (1 + 5 * n) + (4 * pl // 4 if argv[-1] else 0)
        for li, s in enumerate(specs):
            per_px = 18 + 31 + 35  # first derivatives, second derivatives, score + fit
            if not (oi == 0 and li == 0):
                per_px += 18 + 22 + 17 * len(s.taus)  # G_1 blur, conductivity, sweeps
            nops2 += per_px * pl
        oct_p.append(ref)
        seed = ref[5]
    record("fused_octave", source="akaze_tpu_torch/csrc/fed.cu",
           replaces="akaze_tpu/kernels/fed_pallas.py:365", max_abs_err=err2, ms=ms2,
           plain_ms=plain2, bound=bound_ms(nbytes2, nops2))

    # Kernel 3 on the plain twins' stacks and keypoints.
    lvl_oct = tuple({"Lt": o[0], "Lx": o[1], "Ly": o[2]} for o in oct_p)
    fields = tuple({"score": o[3], "sub": o[4]} for o in oct_p)
    kps = detect(find_candidates_oct(fields, ss), fields, ss)
    ang_k, desc_k = describe(kps, lvl_oct, ss, ds)
    ang_p, desc_p = describe_plain(kps, lvl_oct, ss, ds)
    v = kps.valid
    d_ang = (ang_k - ang_p).abs()[v]
    d_ang = torch.minimum(d_ang, 2 * math.pi - d_ang)
    err3 = d_ang.max().item()
    ham = hamming(np, desc_k[v].cpu().numpy(), desc_p[v].cpu().numpy())
    print(f"describe     {int(v.sum())} valid slots: angle max |err| {err3:.3e} rad (tol 1e-5), "
          f"Hamming mean {ham.mean():.3f} (tol 3) max {ham.max()} (tol 12)", flush=True)
    if not (err3 <= 1e-5 and ham.mean() <= 3 and ham.max() <= 12):
        fail("describe disagrees with its plain twin")
    if (desc_k[~v] != 0).any() or (ang_k[~v] != 0).any():
        fail("describe wrote non-zero output to invalid slots")
    ms3 = timed(torch, lambda: describe(kps, lvl_oct, ss, ds))
    plain3 = timed(torch, lambda: describe_plain(kps, lvl_oct, ss, ds), reps=1)
    nv = int(v.sum())
    n_samples = 2 * len(ds.ori_di) + 3 * ds.n_samples
    # Valid slots read their samples and write angle + 16 words; every slot
    # reads its 9 geometry words.  ~31 kflop per valid slot (orientation
    # 3.3k, windows 13.7k, M-LDB sampling 6.2k, cell means 7.4k, bits 0.5k).
    nbytes3 = 4 * (nv * n_samples + B * ss.config.max_keypoints * (9 + 17))
    record("describe", source="akaze_tpu_torch/csrc/describe.cu",
           replaces="akaze_tpu/kernels/describe_fused.py:562", max_abs_err=err3, ms=ms3,
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
    ms4 = timed(torch, lambda: match_reduce(da, va, db, vb))
    plain4 = timed(torch, lambda: match_reduce_plain(da, va, db, vb), reps=1)
    pops = float((va.sum(1).double() * vb.sum(1).double()).sum().item()) * 16
    record("match", source="akaze_tpu_torch/csrc/match.cu",
           replaces="akaze_tpu/kernels/match_pallas.py:95", max_abs_err=0.0, ms=ms4,
           plain_ms=plain4, bound=bound_ms(4 * (da.numel() + db.numel()), pops, POPC_OPS_PER_S))
    del imgs, seed_k, modg_k, seed_p, modg_p, oct_p, lvl_oct, fields, kps, got, ref
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ phase 3
    print(f"\n== main path: extract_batch + consecutive match, batch {B} x {W}x{H}", flush=True)
    frame_sets = [torch.from_numpy(video_sequence(B, H, W, seed=s)).to(dev)
                  for s in range(args.reps + 1)]
    torch.cuda.synchronize()
    _build.reset_launches()
    pass_ms, kp_counts, match_counts = [], [], []
    for i, frames in enumerate(frame_sets):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        feats = extract_batch(frames, config)
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
        if feats.descriptors.shape != (B, config.max_keypoints, 16) or kp.x.shape != (B, config.max_keypoints):
            fail(f"unexpected output shapes {tuple(feats.descriptors.shape)}")
    launches = dict(_build.launches)
    n_batches = len(frame_sets)
    fps = [B / (t / 1e3) for t in pass_ms]
    print(f"passes (ms): {[round(t, 3) for t in pass_ms]}  frames/s: {[round(f, 1) for f in fps]}",
          flush=True)
    print(f"frames/s mean {sum(fps) / len(fps):.1f}, best {max(fps):.1f}", flush=True)
    kc = torch.stack(kp_counts).double()
    mc = torch.stack(match_counts).double()
    print(f"keypoints/frame mean {kc.mean().item():.1f}, accepted matches/pair mean "
          f"{mc.mean().item():.1f}", flush=True)
    print(f"kernels launched over {n_batches} batches: {launches}", flush=True)
    if len({int(c.sum()) for c in kp_counts}) < 2:
        fail("distinct inputs gave identical keypoint counts")
    if kc.min() <= 0:
        fail("a frame produced no keypoints")
    for name in ("base_stage", "fused_octave", "describe", "match"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the main path")
    expect = {"base_stage": 1, "fused_octave": len(groups), "describe": 1, "match": 1}
    for name, per in expect.items():
        if launches[name] != per * n_batches:
            fail(f"{name}: {launches[name]} launches, expected {per} per batch")

    # Stage breakdown of one batch (device time between stages).
    frames = frame_sets[0]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    from akaze_tpu_torch.kernels.fed import build_scale_space

    ev[0].record()
    st = build_scale_space(frames, ss)
    ev[1].record()
    cand = find_candidates_oct(st["oct"], ss)
    ev[2].record()
    kps = detect(cand, st["oct"], ss)
    ev[3].record()
    _, descs = describe(kps, st["lvl_oct"], ss, ds)
    ev[4].record()
    match_fn(descs[:-1], kps.valid[:-1], descs[1:], kps.valid[1:], mcfg)
    ev[5].record()
    torch.cuda.synchronize()
    names = ("scale space (kernels 1-2 + contrast factor)", "candidate top-K", "NMS + top-M + sub-pixel",
             "describe (kernel 3)", "match (kernel 4 + filters)")
    for i, name in enumerate(names):
        print(f"  stage {name}: {ev[i].elapsed_time(ev[i + 1]):.3f} ms", flush=True)
    profile_batch(torch, root, lambda: match(*_pairs(extract_batch(frame_sets[1], config)), mcfg))
    del frame_sets, st, cand, kps, descs, feats
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

    kernels = []
    for name, r in results.items():
        t, by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": t, "bound_by": by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)  # nvidia-smi's name and power limit, as it prints them
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
