"""Kernel 1's plain twin takes the IEEE float32 root of |grad|^2.

torch's float32 CPU root was seen up to ~4,000 ULP off on the first call of
a fresh 8-thread process (1.85e-5 absolute at VGA), and 1 ULP off on later
calls.  The twin roots in float64, rounds to float32 and then moves the
result to the float32 neighbour whose rounding interval holds the root,
decided exactly in float64 (`kernels/fed.ieee_sqrt`), so it is the IEEE
root whatever torch's CPU root does.

The first check runs `base_stage_plain` as the first call of a fresh
subprocess with 8 threads and holds modg equal to numpy's float64 root,
rounded to float32, of the float32 sum of squares of the very gradients
that call computed.  It runs twice: in the test runner's own environment,
and in that of a plain shell (the runner's JAX / XLA / pytest variables
left out).  On a failure the subprocess also says whether torch's sum of
squares or the root parted from numpy's.  The second check feeds the
rounding step roots that are 1 ULP off."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from akaze_tpu_torch.kernels.fed import ieee_sqrt, round_root

_SCRIPT = textwrap.dedent("""
    import numpy as np
    import torch
    torch.set_num_threads(8)
    import akaze_tpu_torch.kernels.fed as fed
    from akaze_tpu_torch.utils.synthetic import video_sequence
    grads = []  # gx, gy as base_stage_plain computes them
    scharr = fed.scharr
    fed.scharr = lambda *a: grads.append(scharr(*a)) or grads[-1]
    sums = []  # the sum of squares the twin roots
    ieee_sqrt = fed.ieee_sqrt
    fed.ieee_sqrt = lambda s: sums.append(s) or ieee_sqrt(s)
    imgs = torch.from_numpy(video_sequence(2, 480, 640, seed=0))
    _, modg = fed.base_stage_plain(imgs, 1.6)
    gx, gy = (g.numpy() for g in grads)
    s = gx * gx + gy * gy
    assert s.dtype == np.float32
    want = np.sqrt(s.astype(np.float64)).astype(np.float32)
    got = modg.numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    s_torch = sums[0].numpy()
    own_root = np.sqrt(s_torch.astype(np.float64)).astype(np.float32)
    print("torch", torch.__version__, torch.backends.cpu.get_cpu_capability(), torch.get_num_threads(), "threads")
    print("pixels off the IEEE root:", int((got != want).sum()), "max ULP", int(ulps.max()))
    print("pixels where torch's sum of squares differs:", int((s_torch != s).sum()),
          "where the root of torch's own sum is off:", int((got != own_root).sum()))
    raise SystemExit(0 if np.array_equal(got, want) else 1)
""")

_LEFT_OUT = ("JAX_", "XLA_", "TPU_", "LIBTPU", "PYTEST_", "ALLOW_MULTIPLE_LIBTPU_LOAD")


def test_base_stage_plain_root_is_ieee_on_first_call():
    root = Path(__file__).resolve().parents[1]
    inherited = {**os.environ, "PYTHONPATH": str(root)}
    plain = {k: v for k, v in inherited.items() if not k.startswith(_LEFT_OUT)}
    for name, env in (("the runner's environment", inherited), ("a plain environment", plain)):
        out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, capture_output=True, text=True,
                             timeout=300, env=env)
        assert out.returncode == 0, f"in {name}:\n" + out.stdout + out.stderr


def test_root_rounding_corrects_roots_one_ulp_off():
    rng = np.random.default_rng(0)
    s = np.concatenate([rng.uniform(0, 1, 200_000), 10.0 ** rng.uniform(-38, 38, 20_000),
                        np.ldexp(1.0, np.arange(-149, 128)), [0.0, 1.0, 4.0, 3.4e38]]).astype(np.float32)
    want = np.sqrt(s.astype(np.float64)).astype(np.float32)
    sd = torch.from_numpy(s).double()
    exact = torch.from_numpy(want)
    for r in (exact, torch.nextafter(exact, torch.full_like(exact, np.inf)),
              torch.nextafter(exact, torch.zeros_like(exact)), torch.sqrt(torch.from_numpy(s))):
        np.testing.assert_array_equal(round_root(sd, r).numpy(), want)
    np.testing.assert_array_equal(ieee_sqrt(torch.from_numpy(s)).numpy(), want)
