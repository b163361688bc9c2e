"""BENCHMARK.json and the files it names: every cell, configuration, mix
and metric found by name, the file within the contract's limits, and a new
cell made of files alone."""

from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests.conftest import ROOT, shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_cell_resolves(bench):
    for name in bench.workloads:
        cell = bench.cell(name)
        assert cell.chips == 1
        assert (cell.dir / "drivers" / f"{cell.mix['entry']}.py").is_file()
        assert (cell.dir / "scenes" / f"{cell.mix['scene']}.py").is_file()
        for trace in (False, True):
            for entry, read in bench.metrics(cell, trace):
                assert callable(read), entry["name"]
        names = [e["name"] for e, _ in bench.metrics(cell, False)]
        assert "setup_s" in names and len(names) >= 2
        assert bench.metrics(cell, True)


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError):
        bench.cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader(ROOT / "benchmark" / "metrics" / "no_such_metric.py")
    cell = bench.cell("tum_vga.batch128")
    cell.mix["entry"] = "no_such_entry"
    with pytest.raises(FileNotFoundError, match="no driver 'no_such_entry'"):
        runner.setup(cell, 1, False, torch.device("cpu"))


def test_file_keeps_to_the_contract():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert data["command"][:2] == ["python3", "benchmark/run.py"]
    assert data["paths"] == ["benchmark"] and 1 <= data["run_seconds"] <= 51
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for x in data[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    pairs = set()
    cells = {w["name"] for w in data["workloads"]}
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "drivers" / f"{mix['entry']}.py").is_file()
        assert (ROOT / "benchmark" / "scenes" / f"{mix['scene']}.py").is_file()
    e2e = {m["name"]: m for m in data["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files beside copies of the benchmark's, with new entries in a copy of
    BENCHMARK.json: the harness runs the new cell without a code change."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    config = json.loads((ROOT / "benchmark" / "configs" / "tum_vga.json").read_text())
    config.update(name="small_cam")
    config["camera"].update(width=160, height=120)
    (bench_dir / "configs" / "small_cam.json").write_text(json.dumps(config))
    mix = json.loads((ROOT / "benchmark" / "traffic" / "batch128.json").read_text())
    mix.update(batch=3, sequences=2, sequence_frames=3, warmup_calls=1)
    (bench_dir / "traffic" / "batch3.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "calls_per_window.py").write_text(
        "def read(run):\n    return run.calls if run.calls else None\n")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "small_cam", "source": "a test", "file": "benchmark/configs/small_cam.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "small_cam.batch3", "config": "small_cam", "traffic": "batch3",
                              "chips": 1, "why": "a test"})
    data["per_layer"].append({"name": "calls_per_window", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "harness", "moves": "frames_per_s",
                              "workloads": ["small_cam.batch3"]})
    next(m for m in data["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append("small_cam.batch3")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    bench = spec.Bench.load(tmp_path, bench_dir=bench_dir)
    cell = bench.cell("small_cam.batch3")
    assert cell.mix["batch"] == 3 and cell.config["camera"]["width"] == 160
    result, rows, _ = runner.execute(bench, cell, 5, 0.5, False, torch.device("cpu"))
    assert result["correct"] and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    result, _, _ = runner.execute(bench, cell, 6, 0.5, True, torch.device("cpu"))
    assert result["metrics"]["calls_per_window"]["value"] >= 1


#: A driver that a later PR could add as a file: one query frame (the first
#: of each call) matched against every other frame of the call, as a
#: relocaliser checks a frame against a keyframe window.
QUERY_DRIVER = '''
from benchmark.harness import check, port
from benchmark.harness.drivers import Driver
from benchmark.reference import akaze as ref_akaze
from benchmark.reference import match as ref_match


class QueryDriver(Driver):
    unit = "frames"

    def __init__(self, run):
        super().__init__(run)
        self.per_call = int(self.mix["window"])

    def frames(self, i):
        return self.pool[i % self.pool.shape[0], : self.per_call]

    def step(self, i):
        feats = port.extract_batch(self.frames(i), self.akaze, device=self.run.device)
        d, v = feats.descriptors, feats.keypoints.valid
        n = d.shape[0] - 1
        m = port.match(d[:1].expand(n, -1, -1), v[:1].expand(n, -1), d[1:], v[1:], self.mcfg,
                       device=self.run.device)
        return check.features_of(feats), check.matches_of(m)

    def pairs_of(self, valid):
        return valid[:1] * (len(valid) - 1), valid[1:]

    def reference(self, lowp=False):
        out = []
        for i, _ in self.sample:
            f = ref_akaze.extract(self.frames(i), self.params, lowp=lowp)
            d, v = f["descriptors"], f["valid"]
            n = d.shape[0] - 1
            out.append((f, ref_match.match(d[:1].expand(n, -1, -1), v[:1].expand(n, -1), d[1:], v[1:],
                                           **self.match_opts)))
        return out


DRIVER = QueryDriver
'''

#: A scene that a later PR could add as a file: low texture, a few soft
#: blobs on a flat field, shifted one pixel per frame.
SOFT_SCENE = '''
import torch


def sequence(mix, frames, height, width, gen, device):
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    u = torch.rand((int(mix["blobs"]), 3), generator=gen, device=device)
    out = torch.empty((frames, height, width), dtype=torch.uint8, device=device)
    for t in range(frames):
        d2 = (x[None] - u[:, 0, None, None] * width - t) ** 2 + (y[None] - u[:, 1, None, None] * height) ** 2
        img = 0.5 + (0.4 * torch.exp(-d2 / (2 * (3 + 12 * u[:, 2, None, None]) ** 2))).sum(0)
        out[t] = torch.round(img.clamp(0, 1) * 255).to(torch.uint8)
    return out
'''


def test_a_new_driver_and_scene_are_files_and_entries(tmp_path):
    """A mix whose loop and frames need new code: the driver and the scene
    come as new files beside copies of the benchmark's, the mix names them,
    and the harness runs the cell, with the reference, without a change to
    any file it had."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    (bench_dir / "drivers" / "query.py").write_text(QUERY_DRIVER)
    (bench_dir / "scenes" / "soft_blobs.py").write_text(SOFT_SCENE)
    config = json.loads((ROOT / "benchmark" / "configs" / "tum_vga.json").read_text())
    config["camera"].update(width=160, height=120)
    (bench_dir / "configs" / "small_cam.json").write_text(json.dumps(config))
    mix = {"entry": "query", "scene": "soft_blobs", "blobs": 40, "window": 4, "sequences": 2,
           "sequence_frames": 4, "warmup_calls": 1, "sample_calls": 2, "profile_calls": 1,
           "limits": {"keypoints_off": 0.05, "descriptor_bits_off": 0.003, "matches_off": 0.05}}
    (bench_dir / "traffic" / "query4.json").write_text(json.dumps(mix))
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": "small_cam", "source": "a test", "file": "benchmark/configs/small_cam.json",
                            "reduced": [], "why": "a test"})
    data["workloads"].append({"name": "small_cam.query4", "config": "small_cam", "traffic": "query4",
                              "chips": 1, "why": "a test"})
    next(m for m in data["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append("small_cam.query4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    bench = spec.Bench.load(tmp_path, bench_dir=bench_dir)
    cell = bench.cell("small_cam.query4")
    result, rows, _ = runner.execute(bench, cell, 2**33 + 21, 0.5, False, torch.device("cpu"))
    assert result["correct"] and all(value == 0.0 for _, value, _ in rows), rows
    assert set(result["metrics"]) == {"frames_per_s", "setup_s"} and result["attempted"] % 4 == 0
    run, drv = runner.setup(cell, 2**33 + 21, False, torch.device("cpu"))
    assert type(drv).__name__ == "QueryDriver"
    scene = spec.load_file("scene", bench_dir / "scenes" / "soft_blobs.py", "sequence")
    gen = torch.Generator().manual_seed(2**33 + 21)
    assert torch.equal(drv.pool, torch.stack([scene(mix, 4, 120, 160, gen, "cpu") for _ in range(2)]))
    assert all(p.read_bytes() == b for p, b in before.items())


def test_the_real_cells_run_on_the_cpu_at_a_small_size(bench):
    for name in bench.workloads:
        cell = shrink(bench.cell(name))
        result, rows, _ = runner.execute(bench, cell, 2**33 + 7, 0.4, False, torch.device("cpu"))
        assert result["correct"], (name, rows)
        assert all(value == 0.0 for _, value, _ in rows), (name, rows)
