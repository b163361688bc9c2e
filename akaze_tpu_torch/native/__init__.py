"""Native (C++) single-core AKAZE and Hamming matcher, built with g++ at
first use (own copy of the JAX package's `native/`; the two `.cpp` files
are byte-equal to its own).

  * hamming.cpp   — brute-force Hamming matcher: ratio test, mutual check
    and distance cap, the oracle for kernel 4's matcher.
  * akaze_cpu.cpp — the full single-core AKAZE detect + describe: the
    measured CPU baseline (`bench_pipeline_native`) and a second oracle next
    to the golden NumPy model, independent of the port's torch code.

The sources are compiled with `g++ -O3 -march=native -shared -fPIC
-std=c++17` into `build/akaze_tpu_torch/native/` at the root of the
checkout (never next to the source), under a name keyed by the hash of the
sources, the flags and the host CPU (`-march=native` code may not run on
another CPU).  Bindings are plain ctypes over a C ABI.  `available()` is
False where g++ is missing or the build fails; `build()` raises with the
compiler's output instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from akaze_tpu_torch.core.config import AkazeConfig

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "hamming.cpp", _DIR / "akaze_cpu.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "akaze_tpu_torch" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_DIFFUSIVITY_CODE = {"pm_g1": 0, "pm_g2": 1, "weickert": 2}

_lib: ctypes.CDLL | None = None
_error: str | None = None


def _cpuinfo() -> tuple[dict, int]:
    """The first CPU's /proc/cpuinfo fields and the count of logical CPUs."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return {}, 0
    info = {}
    for line in text.splitlines():
        key, _, val = line.partition(":")
        info.setdefault(key.strip(), val.strip())
    return info, sum(1 for line in text.splitlines() if line.startswith("processor"))


def cpu_model() -> str:
    """The host CPU from /proc/cpuinfo: its model name (with vendor, family,
    model and clock where a virtualised host reports it as "unknown") and
    the count of logical CPUs."""
    info, n = _cpuinfo()
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"{info.get('vendor_id', platform.machine())} family {info.get('cpu family', '?')} model "
                f"{info.get('model', '?')} (model name not exposed), {info.get('cpu MHz', '?')} MHz")
    return f"{name}, {n} logical CPUs"


def compiler_version() -> str:
    """The first line of `g++ --version`."""
    out = subprocess.run([CXX, "--version"], capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.splitlines()[0].strip()


def library_path() -> Path:
    info, _ = _cpuinfo()
    cpu = [platform.machine()] + [info.get(k, "") for k in ("vendor_id", "cpu family", "model", "model name", "flags")]
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *cpu)).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libakaze_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library, compiled now unless it is there already; raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One compiler per checkout: processes started together (test workers,
    # ranks) wait for the first one's library.
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *CXX_FLAGS, *(str(s) for s in SOURCES), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.akaze_match_hamming.restype = ctypes.c_int
    lib.akaze_match_hamming.argtypes = [
        u32p, ctypes.c_int, u32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, i32p, i32p, u8p,
    ]
    lib.akaze_cpu_extract.restype = ctypes.c_int
    lib.akaze_cpu_extract.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,  # img, h, w
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, u8p,
    ]
    lib.akaze_cpu_bench_pipeline.restype = ctypes.c_double
    lib.akaze_cpu_bench_pipeline.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native AKAZE library could not be built: {_error}")
    return lib


def match_hamming_native(
    a: np.ndarray, b: np.ndarray,
    ratio: float = 0.8, mutual: bool = True, max_distance: int = 486,
):
    """Native brute-force matcher; a/b uint32 (N, W)/(M, W).

    Returns (idx_b (N,) i32, distance (N,) i32, accepted (N,) bool)."""
    lib = _require()
    a = np.ascontiguousarray(a, np.uint32)
    b = np.ascontiguousarray(b, np.uint32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"match_hamming_native: (N, W) and (M, W) descriptors expected, got {a.shape} and {b.shape}")
    na = a.shape[0]
    idx = np.zeros(na, np.int32)
    dist = np.zeros(na, np.int32)
    acc = np.zeros(na, np.uint8)
    if na and b.shape[0]:
        lib.akaze_match_hamming(
            a, na, b, b.shape[0], a.shape[1],
            ctypes.c_float(ratio), int(mutual), int(max_distance),
            idx, dist, acc,
        )
    return idx, dist, acc.astype(bool)


def extract_native(img: np.ndarray, config: AkazeConfig | None = None, max_out: int = 4096):
    """Single-core CPU AKAZE extract (akaze_cpu.cpp).

    Returns (kps float32 (N, 7): x, y, response, size, octave, class_id,
    angle; desc uint8 (N, 61)), in the golden model's keypoint order."""
    lib = _require()
    config = config or AkazeConfig()
    if config.descriptor_channels != 3:
        raise ValueError("extract_native: the native path is fixed at 3 descriptor channels")
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"extract_native: a grayscale (H, W) image expected, got shape {img.shape}")
    kps = np.zeros((max_out, 7), np.float32)
    desc = np.zeros((max_out, 61), np.uint8)
    n = lib.akaze_cpu_extract(
        img, img.shape[0], img.shape[1],
        config.num_octaves, config.num_sublevels,
        ctypes.c_float(config.base_scale_offset),
        ctypes.c_float(config.derivative_factor),
        ctypes.c_float(config.detector_threshold),
        ctypes.c_float(config.contrast_percentile), config.contrast_nbins,
        ctypes.c_float(config.contrast_fallback),
        ctypes.c_float(config.contrast_octave_decay),
        _DIFFUSIVITY_CODE[config.diffusivity.value],
        ctypes.c_float(config.fed_tau_max), config.min_octave_dim,
        config.descriptor_pattern_size,
        max_out, kps, desc,
    )
    return kps[:n], desc[:n]


def bench_pipeline_native(img_a: np.ndarray, img_b: np.ndarray, reps: int = 3, diffusivity: str = "pm_g2") -> float:
    """The measured single-core CPU baseline: seconds per frame of the full
    detect + describe + match pipeline on an image pair, with the
    conductivity `diffusivity` ("pm_g1", "pm_g2" or "weickert")."""
    lib = _require()
    img_a = np.ascontiguousarray(img_a, np.float32)
    img_b = np.ascontiguousarray(img_b, np.float32)
    if img_a.shape != img_b.shape or img_a.ndim != 2:
        raise ValueError(f"bench_pipeline_native: two (H, W) images of one shape expected, got {img_a.shape} "
                         f"and {img_b.shape}")
    return float(
        lib.akaze_cpu_bench_pipeline(
            img_a, img_b, img_a.shape[0], img_a.shape[1], reps,
            _DIFFUSIVITY_CODE[diffusivity],
        )
    )
