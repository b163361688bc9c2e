"""The five adversarial scene classes of the port (`utils/synthetic.py`
`SCENE_CLASSES`) and the conductivity variants of BASELINE config 3,
against the JAX package on the CPU.

* The generators are bit-equal to JAX's at the snapshot's shape and seed
  and at one more.
* Per scene class, the port's CPU `extract` holds to the golden snapshot
  (`tests/data/golden_scene_snapshots.npz`) under
  `tests/test_scene_regression.py`'s gates (count within max(2, 10 %),
  >= 90 % of keypoints within 0.5 px both ways, median Hamming <= 4 bits on
  matched keypoints), and to JAX's CPU `extract` under
  `tests/test_torch_pipeline.py`'s (count within max(2, 2 %), >= 98 % paired
  within 0.01 px on the same level, Hamming mean <= 3 bits).
* `extract_batch` with PM_G1 and Weickert on 2 frames at 120x160 against
  JAX's `extract_batch_fn` under the same pipeline gates."""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import Diffusivity as JaxDiffusivity
from akaze_tpu.frontend.pipeline import extract as jax_extract
from akaze_tpu.frontend.pipeline import extract_batch_fn
from akaze_tpu.utils import synthetic as jax_synthetic
from akaze_tpu_torch import interop
from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.frontend.pipeline import extract, extract_batch
from akaze_tpu_torch.utils import synthetic
from torch_port_helpers import pair_keypoints

torch.set_num_threads(2)

_SNAPSHOT = pathlib.Path(__file__).parent / "data" / "golden_scene_snapshots.npz"
_SCENES = sorted(synthetic.SCENE_CLASSES)


def _snapshot():
    with np.load(_SNAPSHOT) as z:
        # Python ints: an np.int64 shape or seed changes the scene's pixels.
        shape = tuple(int(v) for v in z["image_shape"])
        return shape, int(z["seed"]), {k: z[k] for k in z.files}


def _jax_arrays(feats) -> dict:
    out = {f.name: np.asarray(getattr(feats.keypoints, f.name)) for f in dataclasses.fields(feats.keypoints)}
    out["descriptors"] = np.asarray(feats.descriptors)
    return out


def test_scene_class_names_equal_jax():
    assert sorted(jax_synthetic.SCENE_CLASSES) == _SCENES
    for h, w, a in ((180, 240, 0.6), (97, 131, -1.1)):
        np.testing.assert_array_equal(synthetic.rotation_homography(h, w, a),
                                      jax_synthetic.rotation_homography(h, w, a))


@pytest.mark.parametrize("name", _SCENES)
def test_scene_generators_equal_jax(name):
    shape, seed, _ = _snapshot()
    for (h, w), s in ((shape, seed), ((97, 131), 11)):
        got = synthetic.SCENE_CLASSES[name](h, w, seed=s)
        want = jax_synthetic.SCENE_CLASSES[name](h, w, seed=s)
        assert got.dtype == np.float32 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} at {h}x{w} seed {s}")


@pytest.mark.parametrize("name", _SCENES)
def test_scene_extract_holds_to_snapshot_and_jax(name):
    shape, seed, z = _snapshot()
    img = synthetic.SCENE_CLASSES[name](*shape, seed=seed)
    got = interop.features_to_numpy(extract(img, device="cpu"))

    # The snapshot's gates (tests/test_scene_regression.py).
    valid = got["valid"]
    sx, sy = z[f"{name}_x"], z[f"{name}_y"]
    n_got, n_gold = int(valid.sum()), len(sx)
    assert abs(n_got - n_gold) <= max(2, 0.1 * n_gold), (n_got, n_gold)
    if n_gold:
        d2 = (got["x"][valid][:, None] - sx[None, :]) ** 2 + (got["y"][valid][:, None] - sy[None, :]) ** 2
        dmin = np.sqrt(d2.min(1))
        assert (dmin < 0.5).mean() >= 0.9
        assert (np.sqrt(d2.min(0)) < 0.5).mean() >= 0.9
        ok = dmin < 0.5
        gold_words = interop.pack_descriptor_bytes(z[f"{name}_descriptors"])
        ham = np.bitwise_count(gold_words[d2.argmin(1)[ok]] ^ got["descriptors"][valid][ok]).sum(1)
        assert np.median(ham) <= 4, np.median(ham)

    # JAX's CPU extract on the same image (tests/test_torch_pipeline.py's gates).
    ref = _jax_arrays(jax_extract(img, JaxAkazeConfig()))
    n_ref = int(ref["valid"].sum())
    assert abs(n_ref - n_got) <= max(2, 0.02 * n_ref), (n_ref, n_got)
    frac, hams = pair_keypoints(ref, got)
    assert frac >= 0.98
    if len(hams):
        assert hams.mean() <= 3.0


@pytest.mark.parametrize("diff", ["pm_g1", "weickert"])
def test_conductivity_variant_batch_matches_jax(diff):
    frames = jax_synthetic.video_sequence(2, 120, 160, seed=4)
    jcfg = JaxAkazeConfig(diffusivity=JaxDiffusivity(diff))
    ref = _jax_arrays(jax.jit(lambda im: extract_batch_fn(im, jcfg))(jnp.asarray(frames)))
    got = interop.features_to_numpy(extract_batch(frames, AkazeConfig(diffusivity=Diffusivity(diff)), device="cpu"))
    for b in range(2):
        n_ref, n_got = int(ref["valid"][b].sum()), int(got["valid"][b].sum())
        assert n_ref > 10
        assert abs(n_ref - n_got) <= max(2, 0.02 * n_ref), (b, n_ref, n_got)
        frac, hams = pair_keypoints({k: v[b] for k, v in ref.items()}, {k: v[b] for k, v in got.items()})
        assert frac >= 0.98
        assert hams.mean() <= 3.0
