#!/usr/bin/env python3
"""Time edited copies of csrc/describe.cu (kernels 3 and 6) on one GPU.

    python3 tools/describe_variants.py [--batch 128] [--rounds 3] [--only a,b]

Each variant is a list of text edits applied to a copy of the source:
phase ablations (their outputs are wrong; they show what a phase costs)
other decompositions (another split, with the twin's constants set to
match: bit-equal to the twin), and candidate changes (bit-equal to the
unedited kernel).
All copies are built with the port's nvcc flags in parallel, then each is
timed in turn, `rounds` times round-robin, on the main path's inputs
(kernel 3: one batch of VGA frames through the port's scale space and
detect) and on path B's (kernel 6: 4 VGA frames): CUDA events around the
replay of a CUDA graph of `reps` wrapper calls, divided by `reps` (device
time, launch gaps included; torch.profiler does not see the kernels of
libraries loaded this way).  Prints one line per variant and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def blocks(n):
    """Edits for n resident blocks per SM (launch bound and carveout)."""
    return [("#define BLOCKS_PER_SM 8", f"#define BLOCKS_PER_SM {n}")]


ABLATIONS = {
    "no window scan": [("for (int k = r * wlen; k < k1; ++k) {", "for (int k = r * wlen; k < 0; ++k) {")],
    "no cell tasks": [("for (int m = m0; m < m1; ++m) {", "for (int m = m0; m < 0; ++m) {")],
    "no M-LDB loads": [("vt[q] = __ldg(Lt + p[q]);", "vt[q] = (float)p[q];"),
                       ("gx[q] = __ldg(Lx + p[q]);", "gx[q] = (float)(p[q] + 1);"),
                       ("gy[q] = __ldg(Ly + p[q]);", "gy[q] = (float)(p[q] + 2);")],
    "no orientation loads": [("t.ori_w[tid] * __ldg(Lx + p)", "t.ori_w[tid] * (float)p"),
                             ("t.ori_w[tid] * __ldg(Ly + p)", "t.ori_w[tid] * (float)(p + 1)")],
    # Also moves the M-LDB samples (cos/sin become the window sums), so its
    # time mixes the chain with another access pattern.
    "no angle chain": [("angle = mod_2pi(atan2_cephes(best_y, best_x));\n      sm.cs[0] = cosf(angle);\n"
                        "      sm.cs[1] = sinf(angle);",
                        "angle = best_x;\n      sm.cs[0] = best_x;\n      sm.cs[1] = best_y;")],
}

# name -> (kind, [(old, new), ...] edits of csrc/describe.cu, constants of
# kernels/describe.py to set with it).  kind "exact": must equal the
# unedited kernel; "split": must equal the plain twin run with the same
# constants; "ablation": wrong outputs, timed only.
VARIANTS = {
    "base": ("exact", [], {}),
    **{k: ("ablation", v, {}) for k, v in ABLATIONS.items()},
    "9 blocks (L1 28 KB)": ("exact", blocks(9), {}),
    "6 blocks": ("exact", blocks(6), {}),
    "half the blocks resident": ("ablation", [("const int grid = a.n_kp < sms * bps ? a.n_kp : sms * bps;",
                                               "const int grid = a.n_kp < sms * (bps / 2) ? a.n_kp : sms * (bps / 2);")],
                                 {}),
    "256 threads": ("exact", [("#define THREADS 128", "#define THREADS 256"), *blocks(4)], {}),
    "WIN_SPLIT 2": ("split", [("#define WIN_SPLIT 3", "#define WIN_SPLIT 2")], {"WIN_SPLIT": 2}),
    "WIN_SPLIT 6": ("split", [("#define WIN_SPLIT 3", "#define WIN_SPLIT 6")], {"WIN_SPLIT": 6}),
    "CELL_PART 13": ("split", [("#define CELL_PART 25", "#define CELL_PART 13")], {"CELL_PART": 13}),
    "CELL_PART 7": ("split", [("#define CELL_PART 25", "#define CELL_PART 7"),
                              ("#define MAX_TASKS 128", "#define MAX_TASKS 256")],
                    {"CELL_PART": 7, "_MAX_TASKS": 256}),
    "mod_2pi shortcut": ("exact", [("const float r = fmodf(a, TWO_PI);",
                                    "const float r = fabsf(a) < TWO_PI ? a : fmodf(a, TWO_PI);")], {}),
    "sincosf": ("exact", [("sm.cs[0] = cosf(angle);\n      sm.cs[1] = sinf(angle);",
                           "sincosf(angle, &sm.cs[1], &sm.cs[0]);")], {}),
    "selected window adds": ("exact", [("if (in) {  // = adding 0 where out: the sums start at +0 and never turn -0\n"
                                        "        sx = sx + o.x;\n        sy = sy + o.y;\n      }",
                                        "sx = sx + (in ? o.x : 0.f);\n      sy = sy + (in ? o.y : 0.f);")], {}),
}


def build(names, out_dir: Path) -> dict:
    from akaze_tpu_torch.kernels import _build

    src = (ROOT / "akaze_tpu_torch" / "csrc" / "describe.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        text = src
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise SystemExit(f"variant {name!r}: edit not found: {old[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"describe_v{i}.cu"
        cu.write_text(text)
        lib = out_dir / f"libdescribe_v{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{log}")
        regs = [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
        print(f"built {name!r}: {' | '.join(regs[-2:])}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke
    from akaze_tpu_torch.core.config import AkazeConfig
    from akaze_tpu_torch.frontend.describe import DescribeStatics
    from akaze_tpu_torch.frontend.detect import detect, detect_dense, find_candidates_oct
    from akaze_tpu_torch.frontend.pipeline import _statics
    from akaze_tpu_torch.kernels import _build
    from akaze_tpu_torch.kernels import describe as kd
    from akaze_tpu_torch.kernels.describe_single import describe_pallas, describe_pallas_plain
    from akaze_tpu_torch.kernels.fed import build_scale_space, build_scale_space_levels
    from akaze_tpu_torch.utils.synthetic import video_sequence

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    names = [n for n in VARIANTS if not args.only or n in args.only.split(",")]
    if "base" not in names:
        names.insert(0, "base")
    libs = build(names, ROOT / "build" / "describe_variants")
    print(f"card: {chip_smoke.card_line()}", flush=True)

    ss, ds = _statics(640, 480, AkazeConfig())
    imgs = torch.from_numpy(video_sequence(args.batch, 480, 640, seed=100)).to(dev)
    st = build_scale_space(imgs, ss)
    kps = detect(find_candidates_oct(st["oct"], ss), st["oct"], ss)
    lvl_oct = st["lvl_oct"]
    frames = torch.from_numpy(video_sequence(4, 480, 640, seed=200)).to(dev)
    stl = build_scale_space_levels(frames, ss)
    kps6 = detect_dense(stl["Ldet"], ss)
    single = [(kps6.index(f), {k: stl[k][f] for k in ("Lt", "Lx", "Ly")}) for f in range(4)]
    del imgs, frames
    print(f"kernel 3: {int(kps.valid.sum())} valid of {kps.valid.numel()} slots; kernel 6: "
          f"{[int(k.valid.sum()) for k, _ in single]} valid of {single[0][0].valid.numel()} per frame", flush=True)

    def use(name):
        fn = libs[name].describe
        fn.restype = ctypes.c_int
        fn.argtypes = kd._entry().argtypes
        kd._entry = lambda: fn  # launch() looks the entry point up at call time

    entry = kd._entry
    defaults = {k: getattr(kd, k) for k in ("WIN_SPLIT", "CELL_PART", "_MAX_TASKS")}

    def constants(name):
        nonlocal ds
        for k, v in {**defaults, **VARIANTS[name][2]}.items():
            setattr(kd, k, v)
        ds = DescribeStatics(ss.config, ss)  # its device tables hold the kernel table these constants shape

    def outputs():
        return [*kd.describe(kps, lvl_oct, ss, ds), *(x for k, s in single for x in describe_pallas(k, s, ss, ds))]

    def twin():
        return [*kd.describe_plain(kps, lvl_oct, ss, ds),
                *(x for k, s in single for x in describe_pallas_plain(k, s, ss, ds))]

    def graph_ms(fn):
        """Per-call device time of fn: one CUDA graph of args.reps calls,
        replayed between two events."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(args.reps):
                fn()
        g.replay()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    base = None
    times = {n: ([], []) for n in names}
    occ = {}
    for rnd in range(args.rounds):
        for name in names:
            constants(name)
            use(name)
            out = outputs()
            if name not in occ:
                buf = (ctypes.c_int * 5)()
                libs[name].describe_occupancy(buf)
                occ[name] = f"{buf[1]} blocks/SM, {buf[4]} regs"
            kind = VARIANTS[name][0]
            if base is None:
                base = out
                if not all(torch.equal(a, b) for a, b in zip(out, twin())):
                    raise SystemExit("the unedited kernel differs from its plain twin")
            want = base if kind == "exact" else twin() if kind == "split" and rnd == 0 else None
            if want is not None and not all(torch.equal(a, b) for a, b in zip(out, want)):
                raise SystemExit(f"variant {name!r} differs from its reference ({kind})")
            t3 = graph_ms(lambda: kd.describe(kps, lvl_oct, ss, ds))
            t6 = graph_ms(lambda: describe_pallas(*single[0], ss, ds))
            times[name][0].append(t3)
            times[name][1].append(t6)
    kd._entry = entry
    constants("base")
    _build.reset_launches()
    for name in names:
        t3, t6 = times[name]
        print(f"{name:26s} kernel 3 ms {min(t3):.4f}-{max(t3):.4f}  kernel 6 ms {min(t6):.4f}-{max(t6):.4f}"
              f"  {VARIANTS[name][0]}, {occ[name]}", flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
