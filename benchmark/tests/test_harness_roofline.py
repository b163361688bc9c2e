"""The kernels' least times against bytes and operations counted by hand
for one small shape, and the kernel names read from the port's sources."""

from __future__ import annotations

import pytest

from benchmark.harness import roofline
from benchmark.reference import akaze
from benchmark.tests.conftest import ROOT

BW, F32, I8 = 3.35e12, 67e12, 1979e12


def test_base_stage_bound():
    # 2 frames of 8x10: 160 px, 12 B and 72 flop each.
    assert roofline.base_stage(2, 8, 10) == pytest.approx(max(1920 / BW, 11520 / F32))


def test_fused_octave_bound():
    # Octave 0: 2 levels of 4x6 (24 px), the second with 3 FED sweeps, and
    # the half-size seed; octave 1: one level of 2x3 (6 px), 5 sweeps.
    nbytes = 4 * 24 * 11 + 24 + 4 * 6 * 6
    nops = 84 * 24 + (84 + 40 + 17 * 3) * 24 + (84 + 40 + 17 * 5) * 6
    got = roofline.fused_octave(1, [(0, 2, 4, 6), (2, 1, 2, 3)], [0, 3, 5])
    assert (nbytes, nops) == (1224, 7470)
    assert got == pytest.approx(max(nbytes / BW, nops / F32))


def test_describe_and_match_bounds():
    assert roofline.DESCRIBE_SAMPLES == 1541
    assert roofline.describe(10, 64) == pytest.approx(max((4 * 10 * 1541 + 64 * 81) / BW, 310_000 / F32))
    # Two pairs of 4 x 4 slots with 2/4 and 3/1 valid rows: 16 + 13 distances.
    nbytes = 4 * 2 * 8 * 16 + 2 * 8 + 4 * 2 * (12 + 8)
    assert roofline.match(4, 4, 16, [2, 3], [4, 1]) == pytest.approx(max(nbytes / BW, 1024 * 29 / I8))


def test_vga_bounds_are_those_of_the_kernel_table():
    """At batch 128 VGA the counts give the bounds the port's kernel table
    lists: kernel 1 0.141 ms, kernel 2 1.325 ms (bytes both)."""
    st = akaze.Statics(640, 480, akaze.Params())
    assert roofline.base_stage(128, 480, 640) * 1e3 == pytest.approx(0.141, abs=5e-4)
    k2 = roofline.fused_octave(128, st.groups, [len(lv.taus) for lv in st.levels])
    assert k2 * 1e3 == pytest.approx(1.325, abs=5e-3)


def test_kernel_names_from_the_sources():
    names = roofline.kernel_names(ROOT)
    assert names["base_stage_kernel"] == "base_stage"
    assert names["level_diffuse_kernel"] == names["level_detect_kernel"] == "fused_octave"
    assert names["describe_kernel"] == "describe"
    assert names["match_kernel"] == "match"
    assert roofline.kernel_of("void level_diffuse_kernel<256>(float const*, float*, int)", names) == "fused_octave"
    assert roofline.kernel_of("void at::native::vectorized_elementwise_kernel<4>(int)", names) is None
