"""Kernel 1's plain twin takes the IEEE float32 root of |grad|^2.

torch's float32 CPU root was seen up to ~4,000 ULP off on the first call of
a fresh 8-thread process (1.85e-5 absolute at VGA), and 1 ULP off on later
calls; the twin now roots in float64 and rounds to float32, which is the
correctly rounded float32 root.  The check runs `base_stage_plain` as the
first call of a fresh subprocess with 8 threads and holds modg equal to
numpy's float64 root, rounded to float32, of the float32 sum of squares of
the very gradients that call computed."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

_SCRIPT = textwrap.dedent("""
    import numpy as np
    import torch
    torch.set_num_threads(8)
    import akaze_tpu_torch.kernels.fed as fed
    from akaze_tpu_torch.utils.synthetic import video_sequence
    grads = []  # gx, gy as base_stage_plain computes them
    scharr = fed.scharr
    fed.scharr = lambda *a: grads.append(scharr(*a)) or grads[-1]
    imgs = torch.from_numpy(video_sequence(2, 480, 640, seed=0))
    _, modg = fed.base_stage_plain(imgs, 1.6)
    gx, gy = (g.numpy() for g in grads)
    s = gx * gx + gy * gy
    assert s.dtype == np.float32
    want = np.sqrt(s.astype(np.float64)).astype(np.float32)
    print("pixels off the IEEE root:", int((modg.numpy() != want).sum()))
    raise SystemExit(0 if np.array_equal(modg.numpy(), want) else 1)
""")


def test_base_stage_plain_root_is_ieee_on_first_call():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=root, capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stdout + out.stderr
