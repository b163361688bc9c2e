"""The torch copy of the synthetic camera sequences: shapes, type, range,
determinism from the seed."""

from __future__ import annotations

import torch

from benchmark.harness import spec
from benchmark.traffic import generator

MIX = {"sequences": 2, "sequence_frames": 5, "scene": "textured_pan", "pan": {"x_px": 40, "y_px": 25}}
CAM = {"width": 96, "height": 64}


def test_pool_shape_type_and_range():
    pool = generator.pool(MIX, CAM, 7, "cpu")
    assert pool.shape == (2, 5, 64, 96) and pool.dtype == torch.uint8
    assert int(pool.min()) == 0 or int(pool.max()) == 255
    assert float(pool.float().std()) > 20.0  # textured, not flat
    assert not torch.equal(pool[0], pool[1])  # distinct sequences
    assert not torch.equal(pool[0, 0], pool[0, 1])  # the pan moves


def test_same_seed_same_frames_other_seed_other_frames():
    big = 2**33 + 1  # seeds beyond 32 bits
    a = generator.pool(MIX, CAM, big, "cpu")
    assert torch.equal(a, generator.pool(MIX, CAM, big, "cpu"))
    assert not torch.equal(a, generator.pool(MIX, CAM, big + 1, "cpu"))


def test_scene_is_unit_range_float():
    gen = torch.Generator().manual_seed(3)
    scene = spec.load_file("scene", generator.SCENES_DIR / "textured_pan.py", "textured_scene")
    img = scene(40, 50, gen, "cpu")
    assert img.shape == (40, 50) and img.dtype == torch.float32
    assert float(img.min()) == 0.0 and float(img.max()) == 1.0


def test_a_scene_is_found_by_its_name():
    import pytest

    with pytest.raises(FileNotFoundError, match="no scene 'no_such_scene'"):
        generator.pool(dict(MIX, scene="no_such_scene"), CAM, 7, "cpu")


def test_draws():
    mix = {"ransac": {"num_iterations": 16}, "score_sets": 3, "pairs": 2}
    d = generator.draws(mix, 32, 11, "cpu")
    assert d.shape == (3, 2, 16, 32) and d.dtype == torch.float32
    assert torch.equal(d, generator.draws(mix, 32, 11, "cpu"))
    assert float(d.min()) >= 0.0 and float(d.max()) < 1.0
    assert generator.draws({}, 32, 11, "cpu") is None
