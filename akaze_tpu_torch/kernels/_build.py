"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions that take raw device
pointers and a stream and return the launch's `cudaGetLastError()`.  A
source is compiled for sm_90a (Hopper) at first use into
`build/akaze_tpu_torch/` at the root of the checkout, under a name that
carries a hash of the sources, so an edited source is rebuilt and never
loaded stale.  `--use_fast_math` is not passed, so `expf`, `sinf`, `cosf`
and division stay IEEE; `-fmad=false` keeps every `a * b + c` as two
roundings, as the float32 reference (and the plain PyTorch twins) compute
it.  `-Xptxas=-v` makes nvcc report each kernel's registers, spills and
shared memory; `build` returns that report with each library it built.

`launches` holds one plain integer per kernel wrapper: the wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its path went through the kernels.  `counts` holds host-side counts of
the work those launches were given, reckoned from shapes (no device read):
`match_pairs`, the pairs kernel 4 was launched over, and
`match_slot_pairs`, their P * Ka * Kb (row, column) slot pairs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "akaze_tpu_torch"
SOURCES = ("fed", "describe", "match", "patch", "nms", "topk", "contrast")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v",
)

launches = {
    "base_stage": 0, "fused_octave": 0, "describe": 0, "match": 0,
    "fused_level": 0, "gather_patches": 0, "describe_pallas": 0, "nms": 0, "topk": 0,
    "contrast": 0,
}

counts = {"match_pairs": 0, "match_slot_pairs": 0}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    """Zero `launches` and `counts`."""
    for table in (launches, counts):
        for name in table:
            table[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of akaze_tpu_torch need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, tuple[Path, str]]:
    """Compile the named sources that are not built yet, all nvcc processes
    started together: {name: (library, nvcc's output, "" where it was built
    already)}.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: _target(name) for name in names}
    logs = dict.fromkeys(names, "")
    procs = {}
    for name, target in out.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
        else:
            logs[name] = text
            os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: (out[name], logs[name]) for name in names}


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            lib.akaze_strerror.restype = ctypes.c_char_p
            lib.akaze_strerror.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes: list):
    """A C entry point with its argument types declared; it returns an int
    CUDA error code."""
    fn = getattr(library(lib_name), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    if err != 0:
        msg = library(lib_name).akaze_strerror(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Kernel wrappers take CPU tensors (plain twin) or CUDA tensors (the
    kernel); anything else is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors must be on cpu or cuda, got {t.device}")
