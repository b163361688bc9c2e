"""Degenerate inputs through the port's public entry points on the CPU,
against the JAX package (the cases of tests/test_degenerate_inputs.py, at
its sizes): a constant image, a frame under the minimum octave size, the
1241x376 KITTI shape, a uint8 frame, a NaN sensor region, empty descriptor
sets into match, and a multichannel image.

Gates: equal valid masks and counts, finite keypoint fields, coordinates
inside the frame, x and y within 1e-3 px of JAX's and a Hamming mean of at
most 3 bits over the valid slots.  The counts are fixed here as well
(chip_smoke.py phase 10a holds the card to the same numbers, on the same
images: the scenes stored in tests/torch_data/degenerate_images.npz, which
equal the ones generated here), so a drift of either package shows.

The NaN case compares keypoints, not angles or descriptors: the JAX
package's fused describe (run in interpret mode off the TPU) samples by
one-hot matrix products over a whole patch, so a NaN pixel the reference
never samples still turns every orientation sum of that patch into NaN
(NaN x 0), and its angles come out 0; the port samples the pixels it
reads, as the golden model does."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.frontend.pipeline import extract as jax_extract
from akaze_tpu.matching.hamming import match as jax_match
from akaze_tpu_torch.core.config import AkazeConfig, MatchConfig
from akaze_tpu_torch.frontend.pipeline import extract
from akaze_tpu_torch.golden import akaze as golden
from akaze_tpu_torch.matching.hamming import match
from akaze_tpu_torch.utils.synthetic import textured_scene
from torch_port_helpers import hamming

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(max_keypoints=128, per_level_candidates=32)  # tests/test_degenerate_inputs.py's CFG
#: The keypoints the JAX package finds on each case.
COUNTS = {"constant": 0, "sub_40px": 0, "kitti_1241x376": 458, "uint8": 12, "nan_block": 10}
INPUTS = chip_smoke.degenerate_inputs(np, ROOT)


def test_chip_check_holds_the_same_inputs_and_counts():
    assert chip_smoke.DEGENERATE_COUNTS == COUNTS and chip_smoke.DEGENERATE_SMALL == SMALL
    with np.load(ROOT / "tests" / "torch_data" / "degenerate_images.npz") as z:
        for key, (h, w, seed) in {"scene_96x128": (96, 128, 1), "scene_36x38": (36, 38, 2),
                                  "scene_376x1241": (376, 1241, 13)}.items():
            np.testing.assert_array_equal(z[key], textured_scene(h, w, seed=seed))
    assert np.isnan(INPUTS["nan_block"][0]).sum() == 16 and INPUTS["uint8"][0].dtype == np.uint8


@pytest.mark.parametrize("case", list(COUNTS))
def test_degenerate_extract_matches_jax(case):
    img, small = INPUTS[case]
    count = COUNTS[case]
    kw = SMALL if small else {}
    ref = jax_extract(img, JaxAkazeConfig(**kw))
    got = extract(img, AkazeConfig(**kw), device="cpu")
    rv, kp = np.asarray(ref.keypoints.valid), got.keypoints
    v = kp.valid.numpy()
    np.testing.assert_array_equal(v, rv)
    assert int(v.sum()) == count
    for name in ("x", "y", "response", "size", "angle"):
        assert np.isfinite(getattr(kp, name).numpy()[v]).all(), name
    x, y = kp.x.numpy()[v], kp.y.numpy()[v]
    h, w = img.shape
    assert (x >= 0).all() and (x < w).all() and (y >= 0).all() and (y < h).all()
    np.testing.assert_allclose(x, np.asarray(ref.keypoints.x)[rv], atol=1e-3)
    np.testing.assert_allclose(y, np.asarray(ref.keypoints.y)[rv], atol=1e-3)
    assert (got.descriptors.numpy()[~v] == 0).all()
    if case != "nan_block" and v.any():
        assert hamming(np.asarray(ref.descriptors)[rv], got.descriptors.numpy()[v]).mean() <= 3
    if case == "sub_40px":  # the golden model finds nothing either
        assert len(golden.extract(img, AkazeConfig(**SMALL)).keypoints) == 0


@pytest.fixture(scope="module")
def scene_features():
    img = textured_scene(96, 128, seed=1)
    return jax_extract(img, JaxAkazeConfig(**SMALL)), extract(img, AkazeConfig(**SMALL), device="cpu")


@pytest.mark.parametrize("order", ["empty_first", "empty_second", "both_empty"])
def test_empty_descriptor_set_matches_nothing(scene_features, order):
    ref, got = scene_features
    k = SMALL["max_keypoints"]
    sets_j = {"empty": (jnp.zeros((k, 16), jnp.uint32), jnp.zeros((k,), bool)),
              "full": (ref.descriptors, ref.keypoints.valid)}
    sets_t = {"empty": (np.zeros((k, 16), np.uint32), np.zeros(k, bool)),
              "full": (got.descriptors, got.keypoints.valid)}
    a, b = {"empty_first": ("empty", "full"), "empty_second": ("full", "empty"), "both_empty": ("empty", "empty")}[order]
    assert int(got.keypoints.count()) > 0
    assert int(jax_match(*sets_j[a], *sets_j[b], JaxMatchConfig()).count()) == 0
    m = match(*sets_t[a], *sets_t[b], MatchConfig(), device="cpu")
    assert int(m.count()) == 0 and not m.accepted.any()


def test_multichannel_input_rejected():
    img = np.zeros((32, 32, 3), np.float32)
    with pytest.raises(Exception):
        jax_extract(img, JaxAkazeConfig(**SMALL))
    with pytest.raises(ValueError):
        extract(img, AkazeConfig(**SMALL), device="cpu")
