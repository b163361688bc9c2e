"""The port's per-level scale space against the JAX package on the CPU:
kernel 5's plain twin (`fused_level_batched_plain`) against the JAX
`fused_level_batched` in interpret mode, and the per-level build
(`build_scale_space_levels`, here through its twins) against the JAX
`build_scale_space`.

Gate: Lt/Lx/Ly/Ldet within atol 2e-5, the JAX package's own gate between
its scale-space implementations (tests/test_fed_pallas.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
from akaze_tpu.core.config import Diffusivity as JaxDiffusivity
from akaze_tpu.frontend import scale_space as jss
from akaze_tpu.kernels import fed_pallas as jfed
from akaze_tpu.utils.synthetic import textured_scene
from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
from akaze_tpu_torch.frontend import scale_space as tss
from akaze_tpu_torch.kernels import _build
from akaze_tpu_torch.kernels import fed as tfed

torch.set_num_threads(2)

H, W = 96, 128
_KEYS = ("Lt", "Lx", "Ly", "Ldet")


def _frames(seeds=(0, 1), h=H, w=W):
    return np.stack([textured_scene(h, w, seed=s) for s in seeds]).astype(np.float32)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("diff", list(Diffusivity))
def test_fused_level_matches_pallas_interpret(diff, first):
    cfg = AkazeConfig(diffusivity=diff)
    ss = tss.ScaleSpaceStatics(W, H, cfg)
    # Level 0 takes the sigma0 seed; level 3 runs its FED sweeps from the
    # previous level's Lt (a blurred frame stands in for it).
    spec = ss.specs[0 if first else 3]
    assert first or len(spec.taus) > 0
    seed = tss.gaussian_blur(torch.from_numpy(_frames()), cfg.base_scale_offset)
    k = np.array([0.031, 0.047], np.float32)
    n0 = _build.launches["fused_level"]
    got = tfed.fused_level_batched(seed, torch.from_numpy(k), spec, diff, first)
    assert _build.launches["fused_level"] == n0  # CPU tensors take the twin
    with pltpu.force_tpu_interpret_mode():
        want = jfed.fused_level_batched(jnp.asarray(seed.numpy()), jnp.asarray(k), spec,
                                        JaxDiffusivity(diff.value), first)
    for key, g, r in zip(_KEYS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5, err_msg=key)


@pytest.mark.parametrize("size", [(H, W), (101, 133)])
def test_per_level_build_matches_jax(size):
    h, w = size
    imgs = _frames((2, 3), h, w)
    ss = tss.ScaleSpaceStatics(w, h, AkazeConfig())
    jst = jss.ScaleSpaceStatics(w, h, JaxAkazeConfig())
    want = jax.jit(jax.vmap(lambda im: jss.build_scale_space(im, jst)))(jnp.asarray(imgs))
    n0 = _build.launches["fused_level"]
    got = tfed.build_scale_space_levels(torch.from_numpy(imgs), ss)
    assert _build.launches["fused_level"] == n0  # CPU tensors take the twins
    for key in _KEYS:
        assert got[key].shape == (2, ss.num_levels, h, w)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5, err_msg=key)
    np.testing.assert_array_equal(ss.interior, jst.interior)


def test_contrast_factor_of_the_per_level_build_is_exact():
    """Kernel 1's modg (here its twin) and the histogram give JAX's
    compute_contrast_factor bit for bit."""
    imgs = _frames((4, 5))
    _, modg = tfed.base_stage_plain(torch.from_numpy(imgs), AkazeConfig().base_scale_offset)
    got = tss.contrast_factor_from_modg(modg, AkazeConfig()).numpy()
    want = [float(jss.compute_contrast_factor(jnp.asarray(im), JaxAkazeConfig())) for im in imgs]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_per_level_stacks_pad_with_zeros():
    """Each level fills [:h_l, :w_l] of its padded plane and leaves the rest
    zero."""
    ss = tss.ScaleSpaceStatics(W, H, AkazeConfig())
    st = tfed.build_scale_space_levels(torch.from_numpy(_frames()), ss, plain=True)
    for key in _KEYS:
        for i, s in enumerate(ss.specs):
            plane = st[key][:, i]
            assert (plane[:, s.height :] == 0).all() and (plane[:, :, s.width :] == 0).all(), (key, i)
            assert (plane[:, : s.height, : s.width] != 0).any(), (key, i)
