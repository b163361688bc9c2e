"""The port's native C++ AKAZE and Hamming matcher (`akaze_tpu_torch/native/`)
against the JAX package's `native/` and the port's golden model, on the CPU.

The `.cpp` sources are byte-equal to the reference's; the library is built
by g++ into `build/akaze_tpu_torch/native/`.  The matcher equals JAX's
native matcher and the golden matcher (`tests/test_native.py`'s seeded
case, both `mutual` values, empty inputs); `extract_native` equals JAX's
exactly and the golden copy within `tests/test_native.py`'s gates.  Skips
where g++ is missing, as the reference's tests do."""

import pathlib

import numpy as np
import pytest

from akaze_tpu import native as jax_native
from akaze_tpu_torch import interop, native
from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity, MatchConfig
from akaze_tpu_torch.golden import akaze as gold
from akaze_tpu_torch.golden import matching as gmatch
from akaze_tpu_torch.utils.synthetic import textured_scene, video_sequence
from torch_port_helpers import match_descriptors

ROOT = pathlib.Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(), reason="g++ unavailable: native library not built")


@pytest.mark.parametrize("name", ["akaze_cpu.cpp", "hamming.cpp"])
def test_sources_byte_equal_reference(name):
    assert (ROOT / "akaze_tpu_torch" / "native" / name).read_bytes() == (ROOT / "akaze_tpu" / "native" / name).read_bytes()


def test_library_lands_under_build():
    path = native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "akaze_tpu_torch" / "native"
    assert not list((ROOT / "akaze_tpu_torch" / "native").glob("*.so"))
    assert native.compiler_version() and native.cpu_model()


@pytest.mark.parametrize("mutual", [True, False])
def test_matcher_equals_reference_and_golden(mutual):
    rng = np.random.default_rng(0)
    a = match_descriptors(rng, 100)
    b = match_descriptors(rng, 120)
    b[:40] = a[:40]
    cfg = MatchConfig(mutual=mutual)
    idx, dist, acc = native.match_hamming_native(a, b, ratio=cfg.ratio, mutual=cfg.mutual,
                                                 max_distance=cfg.max_distance)
    jidx, jdist, jacc = jax_native.match_hamming_native(a, b, ratio=cfg.ratio, mutual=cfg.mutual,
                                                        max_distance=cfg.max_distance)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(acc, jacc)
    got = {(int(i), int(idx[i])) for i in np.nonzero(acc)[0]}
    want = {(int(i), int(j)) for i, j in gmatch.match(a, b, cfg)}
    assert got == want and len(want) >= 35
    np.testing.assert_array_equal(dist, gmatch.hamming_distance_matrix(a, b)[np.arange(100), idx])


def test_matcher_empty_inputs():
    a = np.zeros((0, 16), np.uint32)
    b = np.zeros((4, 16), np.uint32)
    idx, dist, acc = native.match_hamming_native(a, b)
    assert idx.shape == dist.shape == acc.shape == (0,)
    idx, dist, acc = native.match_hamming_native(b, a)
    assert acc.shape == (4,) and not acc.any()


@pytest.mark.parametrize("kind", ["pm_g2", "pm_g1", "weickert"])
def test_extract_equals_reference(kind):
    from akaze_tpu.core.config import AkazeConfig as JaxAkazeConfig
    from akaze_tpu.core.config import Diffusivity as JaxDiffusivity

    img = textured_scene(180, 240, seed=11)
    kps, desc = native.extract_native(img, AkazeConfig(diffusivity=Diffusivity(kind)))
    jkps, jdesc = jax_native.extract_native(img, JaxAkazeConfig(diffusivity=JaxDiffusivity(kind)))
    assert len(kps) > 50
    np.testing.assert_array_equal(kps, jkps)
    np.testing.assert_array_equal(desc, jdesc)


def test_extract_against_golden_copy():
    img = textured_scene(180, 240, seed=11)
    kps, desc = native.extract_native(img)
    g = interop.golden_to_numpy(gold.extract(img))
    n = interop.native_to_numpy(kps, desc)
    assert len(kps) == len(g["x"])
    # Same order (identical raster / level traversal), near-identical values.
    assert np.abs(n["x"] - g["x"]).max() < 1e-3
    assert np.abs(n["y"] - g["y"]).max() < 1e-3
    np.testing.assert_array_equal(n["class_id"], g["class_id"])
    assert np.abs(n["angle"] - g["angle"]).max() < 1e-4
    bits = np.bitwise_count(n["descriptors"] ^ g["descriptors"]).sum(1)
    assert bits.mean() < 0.5 and bits.max() <= 4


def test_bench_pipeline_runs():
    pair = video_sequence(2, 120, 160, seed=3)
    for kind in ("pm_g2", "weickert"):
        sec = native.bench_pipeline_native(pair[0], pair[1], reps=1, diffusivity=kind)
        assert 0.0 < sec < 60.0
