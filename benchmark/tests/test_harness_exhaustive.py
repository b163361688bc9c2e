"""The cell strecha_dslr.exhaustive30 at a small size on the CPU, through
the program's plain twins: a whole run reads `correct` with every number
0; a pair table that matches one pair against the wrong view, or the pair
list in another order, reads `correct` false, and so does the control
(the reference in bfloat16 in the program's place)."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import check, port, runner
from benchmark.tests.conftest import shrink

CELL = "strecha_dslr.exhaustive30"


def small(bench):
    """The cell at a size the CPU runs in seconds: an orbit of 6 views of
    160x120 (15 pairs, every one checked) with the pan at the mix's share
    of the frame; the driver holds the capacities to the frame (25
    keypoints, 6 candidates a level)."""
    cell = shrink(bench.cell(CELL))
    cell.mix.update(views=6, sequence_frames=6, pan={"x_px": 160 // 3, "y_px": 120 * 5 // 16})
    return cell


def test_whole_run_on_the_cpu(bench):
    cell = small(bench)
    result, rows, _ = runner.execute(bench, cell, 2**33 + 5, 0.6, False, torch.device("cpu"))
    assert result["correct"] is True and all(value == 0.0 for _, value, _ in rows), rows
    assert result["attempted"] % 6 == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"keypoints_off", "descriptor_bits_off", "matches_off"}
    assert {"frames_per_s", "setup_s"} <= set(result["metrics"])


def wrong_view(fn):
    """The first pair of the list, (0, 1), matched against view 2."""
    def wrapped(*a, pairs=None, **k):
        pairs = pairs.clone()
        pairs[0, 1] = 2
        return fn(*a, pairs=pairs, **k)
    return wrapped


def reordered(fn):
    """The pair list matched in reverse order."""
    return lambda *a, pairs=None, **k: fn(*a, pairs=pairs.flip(0).contiguous(), **k)


@pytest.mark.parametrize("fault", [wrong_view, reordered], ids=lambda f: f.__name__)
def test_fault_is_not_correct(bench, monkeypatch, fault):
    monkeypatch.setattr(port, "match", fault(port.match))
    cell = small(bench)
    result, rows, _ = runner.execute(bench, cell, 2**33 + 7, 0.6, False, torch.device("cpu"))
    assert result["correct"] is False, rows
    assert result["checks"]["matches_off"]["value"] > cell.mix["limits"]["matches_off"], rows


def test_control_is_not_correct(bench):
    cell = small(bench)
    run, drv = runner.setup(cell, 2**31 + 13, False, torch.device("cpu"))
    drv.window(0.6)
    correct, rows = check.verdict(runner.judge(drv), cell.mix["limits"])
    assert correct, rows
    correct, rows = check.verdict(runner.judge(drv, lowp=True), cell.mix["limits"])
    assert not correct, rows
