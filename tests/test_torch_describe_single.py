"""The port's single-frame describe against the JAX package on the CPU, on
the same padded stacks and keypoints: `describe(backend="xla")` (kernel 7's
twin and the chunked describe) against the JAX `describe`, and kernel 6's
twin (`describe_pallas_plain`) against the JAX `describe_pallas` in
interpret mode.

Gates, the JAX package's own between its describes
(tests/test_pallas_describe.py): angles within 1e-5 rad, Hamming median 0
and max <= 4 bits over valid slots, invalid slots zero."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.frontend.describe import describe as jax_describe
from akaze_tpu.frontend.detect import detect as jax_detect
from akaze_tpu.frontend.pipeline import _statics as jax_statics
from akaze_tpu.frontend.scale_space import build_scale_space
from akaze_tpu.kernels.describe_pallas import describe_pallas as jax_describe_pallas
from akaze_tpu.utils.synthetic import video_sequence
from akaze_tpu_torch.core.config import AkazeConfig
from akaze_tpu_torch.core.types import Keypoints
from akaze_tpu_torch.frontend.describe import describe
from akaze_tpu_torch.frontend.pipeline import _statics
from akaze_tpu_torch.kernels import _build
from torch_port_helpers import hamming, wrapped_angle_diff

torch.set_num_threads(2)

H, W = 240, 320


# Keypoints planted on the deepest octave (levels 8-11 are 80x60 at
# 320x240, against a 64x64 patch): (x, y) in octave-0 pixels, level.
PLANTED = [(100.0, 200.0, 11), (300.0, 220.0, 10), (20.0, 20.0, 9), (160.0, 120.0, 8)]


def _scene(max_keypoints, plant_at=None):
    jcfg = JaxAkazeConfig(max_keypoints=max_keypoints)
    jss, jds = jax_statics(W, H, jcfg)
    img = jnp.asarray(video_sequence(1, H, W, seed=3)[0])
    st = jax.jit(lambda im: build_scale_space(im, jss))(img)
    kp = jax.jit(lambda ld: jax_detect(ld, jss))(st["Ldet"])
    if plant_at is not None:
        at = slice(plant_at, plant_at + len(PLANTED))
        x, y, lvl = (np.asarray(a, t) for a, t in zip(zip(*PLANTED), (np.float32, np.float32, np.int32)))
        kp = dataclasses.replace(kp, x=kp.x.at[at].set(x), y=kp.y.at[at].set(y),
                                 class_id=kp.class_id.at[at].set(lvl), valid=kp.valid.at[at].set(True))
    ss, ds = _statics(W, H, AkazeConfig(max_keypoints=max_keypoints))
    tkp = Keypoints(**{f.name: torch.from_numpy(np.array(getattr(kp, f.name)))
                       for f in dataclasses.fields(Keypoints)})
    tst = {k: torch.from_numpy(np.asarray(st[k])) for k in ("Lt", "Lx", "Ly")}
    return (jss, jds, st, kp), (ss, ds, tst, tkp)


@pytest.fixture(scope="module")
def scene64():
    return _scene(64)


def _check(ang_ref, desc_ref, ang, desc, valid):
    assert valid.sum() > 30
    assert wrapped_angle_diff(ang_ref[valid], ang[valid]).max() < 1e-5
    ham = hamming(desc_ref[valid], desc[valid])
    assert np.median(ham) == 0 and ham.max() <= 4
    assert (desc[~valid] == 0).all() and (ang[~valid] == 0).all()


def test_describe_xla_matches_jax():
    """At the default capacity (1024 slots: four chunks, the last two
    dead) with keypoints planted in the second chunk on the deepest octave,
    whose windows reach into the stacks' zero padding."""
    (jss, jds, st, kp), (ss, ds, tst, tkp) = _scene(1024, plant_at=300)
    want = jax_describe(kp, st, jss, jds)
    n0 = _build.launches["gather_patches"]
    got = describe(tkp, tst, ss, ds)
    assert _build.launches["gather_patches"] == n0  # CPU tensors take the twins
    valid = tkp.valid.numpy()
    assert valid[300:304].all() and not valid[512:].any()
    _check(np.asarray(want.keypoints.angle), np.asarray(want.descriptors).view(np.int32),
           got.keypoints.angle.numpy(), got.descriptors.numpy(), valid)


def test_describe_pallas_twin_matches_jax_interpret(scene64):
    (jss, jds, st, kp), (ss, ds, tst, tkp) = scene64
    ja, jd = jax_describe_pallas(kp, st, jss, jds, interpret=True)
    n0 = _build.launches["describe_pallas"]
    got = describe(tkp, tst, ss, ds, backend="pallas")
    assert _build.launches["describe_pallas"] == n0
    _check(np.asarray(ja), np.asarray(jd).view(np.int32), got.keypoints.angle.numpy(),
           got.descriptors.numpy(), tkp.valid.numpy())


def test_describe_backends_agree_with_holes(scene64):
    """Invalid slots inside the valid prefix are zeroed and every valid
    slot after them is described, on both backends."""
    _, (ss, ds, tst, tkp) = scene64
    holes = [2, 5, 9, 10]
    kp = dataclasses.replace(tkp, valid=tkp.valid.clone())
    kp.valid[holes] = False
    x = describe(kp, tst, ss, ds)
    p = describe(kp, tst, ss, ds, backend="pallas")
    v = kp.valid.numpy()
    _check(x.keypoints.angle.numpy(), x.descriptors.numpy(), p.keypoints.angle.numpy(),
           p.descriptors.numpy(), v)
    assert (x.descriptors.numpy()[holes] == 0).all()
    assert (x.descriptors.numpy()[v] != 0).any(axis=-1).all()
    with pytest.raises(ValueError):
        describe(kp, tst, ss, ds, backend="fused")
