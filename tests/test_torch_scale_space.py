"""PyTorch port's scale space (base stage, contrast factor, per-octave
builder) against the JAX package's Pallas builder in interpret mode.

Gates are those of tests/test_fed_pallas.py: Lt/Lx/Ly within 2e-5, scores
within atol 2e-6 / rtol 1e-6, equal sub-pixel keep flags and offsets within
1e-4 at candidate sites; the contrast factor is bit-exact."""

import dataclasses

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
from akaze_tpu_torch.frontend.scale_space import ScaleSpaceStatics, contrast_factor_from_modg
from akaze_tpu_torch.kernels import fed as tfed

torch.set_num_threads(2)


def _imgs(seeds, h=96, w=128):
    return np.stack([textured_scene(h, w, seed=s) for s in seeds]).astype(np.float32)


@pytest.mark.parametrize("diff", ["pm_g1", "pm_g2", "weickert"])
def test_builder_matches_pallas_interpret(diff):
    imgs = _imgs((2, 3))
    jst = jss.ScaleSpaceStatics(128, 96, JaxAkazeConfig(diffusivity=JaxDiffusivity(diff)))
    with pltpu.force_tpu_interpret_mode():
        ref = jax.jit(lambda im: jfed.build_scale_space_pallas_batched(im, jst, with_detect=True))(
            jnp.asarray(imgs)
        )
    st = ScaleSpaceStatics(128, 96, AkazeConfig(diffusivity=Diffusivity(diff)))
    got = tfed.build_scale_space(torch.from_numpy(imgs), st)
    assert len(got["lvl_oct"]) == len(ref["lvl_oct"]) == 2
    checked = 0
    for oi, (r, g) in enumerate(zip(ref["lvl_oct"], got["lvl_oct"])):
        for key in ("Lt", "Lx", "Ly"):
            assert g[key].shape == r[key].shape  # level-major (n, B, h, w)
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), atol=2e-5,
                                       err_msg=f"octave {oi} {key}")
    for oi, (r, g) in enumerate(zip(ref["oct"], got["oct"])):
        rs, gs = np.asarray(r["score"]), g["score"].numpy()
        np.testing.assert_allclose(gs, rs, atol=2e-6, rtol=1e-6, err_msg=f"octave {oi} score")
        cand = rs > -1e38
        checked += int(cand.sum())
        oxr, oyr, kr = (np.asarray(a) for a in jfed.unpack_sub(r["sub"]))
        oxg, oyg, kg = (a.numpy() for a in tfed.unpack_sub(g["sub"]))
        np.testing.assert_array_equal(kg[cand], kr[cand])
        both = cand & kg
        np.testing.assert_allclose(oxg[both], oxr[both], atol=1e-4)
        np.testing.assert_allclose(oyg[both], oyr[both], atol=1e-4)
    assert checked > 10


def test_builder_matches_xla_odd_size():
    """An odd frame size (ragged octaves, half-size dropping a trailing row
    and column) against the JAX batched builder's XLA octave path."""
    imgs = _imgs((6, 7), h=97, w=131)
    jst = jss.ScaleSpaceStatics(131, 97, JaxAkazeConfig(pallas_octaves=0))
    ref = jax.jit(lambda im: jfed.build_scale_space_pallas_batched(im, jst, with_detect=True))(
        jnp.asarray(imgs)
    )
    got = tfed.build_scale_space(torch.from_numpy(imgs), ScaleSpaceStatics(131, 97, AkazeConfig()))
    assert [o["Lt"].shape[2:] for o in got["lvl_oct"]] == [(97, 131), (48, 65)]
    for r, g in zip(ref["lvl_oct"], got["lvl_oct"]):
        for key in ("Lt", "Lx", "Ly"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), atol=2e-5, err_msg=key)
    for r, g in zip(ref["oct"], got["oct"]):
        rs = np.asarray(r["score"])
        np.testing.assert_allclose(g["score"].numpy(), rs, atol=2e-6, rtol=1e-6)
        cand = rs > -1e38
        kr = np.asarray(jfed.unpack_sub(r["sub"])[2])
        np.testing.assert_array_equal(tfed.unpack_sub(g["sub"])[2].numpy()[cand], kr[cand])


def test_octave_half_seed_matches_pallas():
    """The in-kernel half-size seed handed to the next octave."""
    imgs = _imgs((0, 1))
    jcfg = JaxAkazeConfig()
    jst = jss.ScaleSpaceStatics(128, 96, jcfg)
    seed = jss.gaussian_blur(jnp.asarray(imgs), jcfg.base_scale_offset)
    k = jnp.asarray([0.02, 0.03], jnp.float32)
    specs = tuple(jst.specs[:4])
    with pltpu.force_tpu_interpret_mode():
        ref = jfed.fused_octave_batched(
            seed, k, specs, jcfg.diffusivity, first=True, with_detect=True,
            threshold=float(jcfg.detector_threshold), with_half=True,
        )
    st = ScaleSpaceStatics(128, 96, AkazeConfig())
    got = tfed.fused_octave(
        torch.from_numpy(np.array(seed)), torch.tensor([0.02, 0.03]), tuple(st.specs[:4]),
        Diffusivity.PM_G2, True, float(AkazeConfig().detector_threshold), True,
    )
    assert got[5].shape == (2, 48, 64)
    np.testing.assert_allclose(got[5].numpy(), np.asarray(ref[-1]), atol=2e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=2e-5)


def test_base_stage_matches_reference():
    """seed = G_1.6 * img and modg = |Scharr grad(G_1 * img)| against the
    JAX XLA filters and the JAX base-stage kernel in interpret mode."""
    imgs = _imgs((4, 5))
    seed, modg = tfed.base_stage(torch.from_numpy(imgs), 1.6)
    x = jnp.asarray(imgs)
    sm = jss.gaussian_blur(x, 1.0)
    gx, gy = jss.scharr(sm, 1, 0, 1), jss.scharr(sm, 0, 1, 1)
    np.testing.assert_allclose(seed.numpy(), np.asarray(jss.gaussian_blur(x, 1.6)), atol=2e-5)
    np.testing.assert_allclose(modg.numpy(), np.asarray(jnp.sqrt(gx * gx + gy * gy)), atol=2e-5)
    with pltpu.force_tpu_interpret_mode():
        rs, rm = jfed.base_stage_batched(x, 1.6)
    np.testing.assert_allclose(seed.numpy(), np.asarray(rs), atol=2e-5)
    np.testing.assert_allclose(modg.numpy(), np.asarray(rm), atol=2e-5)


@pytest.mark.parametrize("nbins,percentile", [(7, 0.05), (64, 0.7), (300, 0.7), (301, 0.99)])
def test_contrast_factor_bit_exact(nbins, percentile):
    """Same modg planes in, the identical float32 contrast factor out."""
    imgs = np.stack([textured_scene(60, 80, seed=s) for s in range(4)])
    imgs[3] = 0.5  # flat frame: the fallback branch
    x = jnp.asarray(imgs)
    sm = jss.gaussian_blur(x, 1.0)
    gx, gy = jss.scharr(sm, 1, 0, 1), jss.scharr(sm, 0, 1, 1)
    modg = np.array(jnp.sqrt(gx * gx + gy * gy))
    jcfg = dataclasses.replace(JaxAkazeConfig(), contrast_nbins=nbins, contrast_percentile=percentile)
    cfg = AkazeConfig(contrast_nbins=nbins, contrast_percentile=percentile)
    want = np.asarray(jax.vmap(lambda m: jss.contrast_factor_from_modg(m, jcfg))(jnp.asarray(modg)))
    got = contrast_factor_from_modg(torch.from_numpy(modg), cfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[3] == np.float32(cfg.contrast_fallback)
