"""The front end at photogrammetry sizes on the card: one 3072x2048 frame
with 8,192 keypoints and 2,048 candidates per level through
`extract_batch` (kernels 1-3 and the NMS kernel) is bit-equal to the same
frame through the plain twins, and the NMS kernel's masked responses equal
its plain form's on the frame's real candidates, several windows of them
per level.  `gpu`-marked, skipping without a card; the file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_highres.py
"""

import sys
from pathlib import Path

import pytest
import torch

from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.frontend.detect import find_candidates_oct
from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch, extract_batch_fn
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels.fed import NEG, build_scale_space
from akaze_tpu_torch.kernels.nms import cross_level_nms, cross_level_nms_plain
from torch_port_helpers import cuda  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.scenes.textured_pan import textured_scene  # noqa: E402

pytestmark = pytest.mark.gpu

H, W = 2048, 3072
CFG = AkazeConfig(max_keypoints=8192, per_level_candidates=2048)
#: The NMS kernel's block threads and staged window (csrc/nms.cu THREADS, CAP).
NMS_THREADS, NMS_CAP = 256, 768
FIELDS = ("x", "y", "response", "size", "octave", "class_id", "angle", "valid")


def _frame(cuda, seed=20):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    return torch.round(textured_scene(H, W, gen, cuda) * 255.0).to(torch.uint8)[None]


def test_dslr_frame_kernels_equal_plain(cuda):
    frame = _frame(cuda)
    _build.reset_launches()
    fk = extract_batch(frame, CFG, device=cuda)
    torch.cuda.synchronize()
    assert all(_build.launches[k] == n for k, n in
               {"base_stage": 1, "fused_octave": 4, "nms": 1, "describe": 1}.items()), _build.launches
    fp = extract_batch_fn(frame, CFG, plain=True)
    for name in FIELDS:
        assert torch.equal(getattr(fk.keypoints, name), getattr(fp.keypoints, name)), name
    assert torch.equal(fk.descriptors, fp.descriptors)
    assert int(fk.keypoints.valid.sum()) > 1024  # past the camera configurations' whole capacity


def test_dslr_candidates_nms_kernel_equals_plain(cuda):
    ss, _ = _statics(W, H, CFG)
    imgs = _frame(cuda, seed=21).to(torch.float32) / 255.0
    cand = find_candidates_oct(build_scale_space(imgs, ss)["oct"], ss)
    per_level = cand["valid"].sum(-1)[0]
    near = per_level + torch.cat([per_level[1:], per_level[:1] * 0]) + torch.cat([per_level[:1] * 0, per_level[:-1]])
    assert int(per_level.max()) > NMS_THREADS and int(near.max()) > NMS_CAP, per_level.tolist()
    masked = cross_level_nms(cand, ss)
    keep = cross_level_nms_plain(cand, ss)
    assert torch.equal(masked, torch.where(keep, cand["resp"], torch.full_like(cand["resp"], NEG)))
    assert bool((cand["valid"] & ~keep).any())
