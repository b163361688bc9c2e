"""The least time the H100 could take for each of the port's kernels 1-4
on one call's inputs: the larger of the bytes moved once over the HBM
bandwidth and the operations over the peak for their type.  The byte and
operation counts are those the port's own kernel checks reckon, copied
here so that the yardstick stays with the benchmark.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense
rates): 3.35 TB/s HBM, 67 TFLOP/s float32 outside the tensor cores,
1,979 TOP/s int8 on the tensor cores (kernel 4 counts each 486-bit
distance as 1,024 one-bit operations there).
"""

from __future__ import annotations

import re
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
#: Samples a valid slot reads in the describe: 2 x 109 orientation
#: samples (Lx, Ly) and 3 x 441 M-LDB samples (Lt, Lx, Ly).
DESCRIBE_SAMPLES = 2 * 109 + 3 * 441

#: Which kernel each `__global__` function of the port's CUDA sources
#: belongs to, by source file (fed.cu's base stage is kernel 1).
KERNEL_OF_SOURCE = {"fed": "fused_octave", "describe": "describe", "match": "match"}


def bound_s(nbytes: float, nops: float, ops_per_s: float = FP32_OPS_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / ops_per_s)


def base_stage(frames: int, height: int, width: int) -> float:
    """Kernel 1: one plane read, two written; ~72 flop/px (the sigma0 blur
    34, the G_1 blur 18, two Scharr 16, the magnitude 4)."""
    px = frames * height * width
    return bound_s(12 * px, 72 * px)


def fused_octave(frames: int, groups, taus_per_level) -> float:
    """Kernel 2 over the octaves (first level, count, h, w): per octave the
    seed read, Lt, Lx, Ly, score and sub written per level, the next
    octave's half-size seed; per level 84 flop/px of derivatives, second
    derivatives and the detect fit, and past the first level 40 of blur
    and conductivity and 17 per FED sweep."""
    nbytes = nops = 0.0
    for oi, (l0, n, h, w) in enumerate(groups):
        pl = frames * h * w
        nbytes += 4 * pl * (1 + 5 * n) + (pl if oi + 1 < len(groups) else 0)
        for li in range(n):
            per_px = 18 + 31 + 35
            if not (oi == 0 and li == 0):
                per_px += 18 + 22 + 17 * taus_per_level[l0 + li]
            nops += per_px * pl
    return bound_s(nbytes, nops)


def describe(valid: int, slots: int) -> float:
    """Kernel 3: each valid slot reads its samples; every slot reads x, y,
    class_id, valid (13 B) and writes an angle and 16 words; ~31 kflop per
    valid slot."""
    return bound_s(4 * valid * DESCRIBE_SAMPLES + slots * (13 + 4 * 17), 31_000 * valid)


def match(rows_a: int, rows_b: int, words: int, valid_a, valid_b) -> float:
    """Kernel 4 over pairs with (Ka, Kb) slots and valid counts na, nb: per
    pair Ka * nb + na * Kb - na * nb distances, 1,024 int8 tensor-core
    operations each; descriptors and masks read, five int32 vectors
    written."""
    pairs = len(valid_a)
    n_dist = sum(rows_a * nb + na * rows_b - na * nb for na, nb in zip(valid_a, valid_b))
    nbytes = (4 * pairs * (rows_a + rows_b) * words + pairs * (rows_a + rows_b)
              + 4 * pairs * (3 * rows_a + 2 * rows_b))
    return bound_s(nbytes, 1024 * n_dist, INT8_OPS_PER_S)


def kernel_names(root: Path) -> dict:
    """{`__global__` function name: kernel} of the port's CUDA sources
    under `root` (the checkout)."""
    names = {}
    for src in sorted((Path(root) / "akaze_tpu_torch" / "csrc").glob("*.cu")):
        for fn in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src.read_text()):
            names[fn] = "base_stage" if fn.startswith("base_stage") else KERNEL_OF_SOURCE.get(src.stem, src.stem)
    return names


def kernel_of(event_name: str, names: dict) -> str | None:
    """The kernel of a profiler row ("void f<256>(float const*, ...)" or
    "f(...)"), or None for a row of another library."""
    return names.get(re.sub(r"^void\s+", "", event_name).split("(")[0].split("<")[0])
