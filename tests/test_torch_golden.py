"""The port's golden NumPy oracle (`akaze_tpu_torch/golden/`) against the
JAX package's golden model on the CPU.

Each building block (`conductivity_np` for all three kinds,
`diffusion_step`, `compute_contrast_factor`, the scale space and
`detector_response`, `pack_descriptor_u32`, `hamming_distance_matrix`,
`match`) must equal the original exactly on seeded inputs (and
`empty_keypoints` / `keypoints_to_numpy` theirs), and the copy's
`extract` must equal `tests/data/golden_snapshot.npz` exactly: on the
scene generated here, and on the stored image the snapshot was made from
(`tests/torch_data/golden_snapshot_image.npz`; numpy's float32 sin and exp
differ by a few ULP between numpy versions, so a machine with another numpy
generates a slightly different scene)."""

import dataclasses
import pathlib

import numpy as np
import pytest

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import Diffusivity as JaxDiffusivity
from akaze_tpu.core.config import MatchConfig as JaxMatchConfig
from akaze_tpu.core.types import empty_keypoints as jax_empty_keypoints
from akaze_tpu.core.types import keypoints_to_numpy as jax_keypoints_to_numpy
from akaze_tpu.golden import akaze as jgold
from akaze_tpu.golden import matching as jmatch
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig
from akaze_tpu_torch.core.types import empty_keypoints, keypoints_to_numpy
from akaze_tpu_torch.golden import akaze as gold
from akaze_tpu_torch.golden import matching as gmatch
from akaze_tpu_torch.utils.synthetic import textured_scene
from torch_port_helpers import match_descriptors

DATA = pathlib.Path(__file__).parent
_SNAPSHOT = DATA / "data" / "golden_snapshot.npz"
_IMAGE = DATA / "torch_data" / "golden_snapshot_image.npz"
_KEYS = ("x", "y", "response", "size", "octave", "class_id", "angle")


def _snapshot():
    with np.load(_SNAPSHOT) as z:
        snap = {k: z[k] for k in z.files}
    return snap, tuple(int(v) for v in snap["image_shape"]), int(snap["seed"])


def _assert_equals_snapshot(res, snap):
    got = interop.golden_to_numpy(res)
    assert len(res.keypoints) == len(snap["x"])
    for key in _KEYS:
        np.testing.assert_array_equal(got[key], snap[key], err_msg=key)
    np.testing.assert_array_equal(res.descriptors, snap["descriptors"])
    np.testing.assert_array_equal(got["descriptors"], res.descriptors_u32)


@pytest.mark.parametrize("kind", ["pm_g1", "pm_g2", "weickert"])
def test_conductivity_equals_jax(kind):
    rng = np.random.default_rng(1)
    lx = rng.normal(0, 0.05, (37, 53)).astype(np.float32)
    ly = rng.normal(0, 0.05, (37, 53)).astype(np.float32)
    lx[3, :7] = 0.0  # grad2 == 0: Weickert's guarded branch
    ly[3, :7] = 0.0
    got = gold.conductivity_np(lx, ly, 0.021, Diffusivity(kind))
    want = jgold.conductivity_np(lx, ly, 0.021, JaxDiffusivity(kind))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_diffusion_step_and_contrast_factor_equal_jax():
    rng = np.random.default_rng(2)
    lt = rng.random((41, 59), dtype=np.float32)
    g = rng.random((41, 59), dtype=np.float32)
    for tau in (0.25, 1.7, 4.2):
        np.testing.assert_array_equal(gold.diffusion_step(lt, g, tau), jgold.diffusion_step(lt, g, tau))
    img = textured_scene(97, 131, seed=4)
    assert gold.compute_contrast_factor(img, AkazeConfig()) == jgold.compute_contrast_factor(img, JaxAkazeConfig())
    flat = np.full((40, 50), 0.5, np.float32)
    assert gold.compute_contrast_factor(flat, AkazeConfig()) == AkazeConfig().contrast_fallback


@pytest.mark.parametrize("kind", ["pm_g2", "weickert"])
def test_scale_space_and_detector_response_equal_jax(kind):
    img = textured_scene(97, 131, seed=5)
    cfg, jcfg = AkazeConfig(diffusivity=Diffusivity(kind)), JaxAkazeConfig(diffusivity=JaxDiffusivity(kind))
    got = gold.create_nonlinear_scale_space(img, cfg)
    want = jgold.create_nonlinear_scale_space(img, jcfg)
    gold.detector_response(got, cfg)
    jgold.detector_response(want, jcfg)
    assert len(got) == len(want) > 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert dataclasses.astuple(g.spec) == dataclasses.astuple(w.spec)
        for name in ("Lt", "Lsmooth", "Lx", "Ly", "Ldet"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=f"level {i} {name}")


def test_extract_equals_jax_on_another_scene():
    img = textured_scene(97, 131, seed=6)
    got, want = gold.extract(img), jgold.extract(img)
    assert len(got.keypoints) == len(want.keypoints) > 5
    for g, w in zip(got.keypoints, want.keypoints):
        assert dataclasses.astuple(g) == dataclasses.astuple(w)
    np.testing.assert_array_equal(got.descriptors, want.descriptors)
    np.testing.assert_array_equal(got.descriptors_u32, want.descriptors_u32)


def test_pack_descriptor_equals_jax():
    rng = np.random.default_rng(3)
    for n in (61, 40, 64):
        d = rng.integers(0, 256, n, dtype=np.uint8)
        got = gold.pack_descriptor_u32(d)
        assert got.dtype == np.uint32 and got.shape == (16,)
        np.testing.assert_array_equal(got, jgold.pack_descriptor_u32(d))
    d = rng.integers(0, 256, (5, 61), dtype=np.uint8)
    np.testing.assert_array_equal(interop.pack_descriptor_bytes(d), np.stack([gold.pack_descriptor_u32(r) for r in d]))


@pytest.mark.parametrize("mutual", [True, False])
def test_matching_equals_jax(mutual):
    rng = np.random.default_rng(0)
    a = match_descriptors(rng, 90)
    b = match_descriptors(rng, 110)
    b[:30] = a[:30]
    np.testing.assert_array_equal(gmatch.hamming_distance_matrix(a, b), jmatch.hamming_distance_matrix(a, b))
    got = gmatch.match(a, b, MatchConfig(mutual=mutual, max_distance=200))
    want = jmatch.match(a, b, JaxMatchConfig(mutual=mutual, max_distance=200))
    assert got.dtype == np.int64 and len(got) >= 30
    np.testing.assert_array_equal(got, want)
    empty = np.zeros((0, 16), np.uint32)
    assert gmatch.match(empty, b).shape == (0, 2) and gmatch.match(a, empty).shape == (0, 2)


def test_extract_equals_snapshot_exactly():
    snap, shape, seed = _snapshot()
    _assert_equals_snapshot(gold.extract(textured_scene(*shape, seed=seed)), snap)


def test_stored_snapshot_image_reproduces_snapshot():
    snap, shape, seed = _snapshot()
    with np.load(_IMAGE) as z:
        img = z["image"]
    assert img.dtype == np.float32 and img.shape == shape
    # The stored image is this scene up to numpy's float32 sin / exp.
    here = textured_scene(*shape, seed=seed)
    ulps = np.abs(img.view(np.int32).astype(np.int64) - here.view(np.int32))
    assert ulps.max() <= 4
    _assert_equals_snapshot(gold.extract(img), snap)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_empty_keypoints_equal_jax(batch):
    got = keypoints_to_numpy(empty_keypoints(16, batch, device="cpu"))
    want = jax_keypoints_to_numpy(jax_empty_keypoints(16, batch))
    assert got.keys() == want.keys()
    for key, val in want.items():
        assert got[key].dtype == val.dtype and got[key].shape == (*batch, 16)
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    kp = empty_keypoints(4, device="cpu")
    kp.x[0] = 1.0  # the fields are separate tensors
    assert kp.y[0] == 0 and kp.count() == 0
