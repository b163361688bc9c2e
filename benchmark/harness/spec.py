"""What `BENCHMARK.json` names, found by name in files of their own.

    bench = Bench.load(root)            # root holds BENCHMARK.json
    cell = bench.cell("tum_vga.batch128")
    cell.config, cell.mix               # benchmark/configs/<config>.json, benchmark/traffic/<mix>.json
    bench.metrics(cell, trace=False)    # [(entry, reader)], readers from benchmark/metrics/<name>.py

A mix names the code it needs by file too: its "entry" the driver of its
loop (`benchmark/drivers/<entry>.py`, a `DRIVER` class) and its "scene" the
maker of its frames (`benchmark/scenes/<scene>.py`, a `sequence` function).
A new cell, configuration, traffic mix, driver, scene or per-layer metric
is new files under `benchmark/` and new entries in `BENCHMARK.json`;
nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    dir: Path = BENCH_DIR  # the benchmark's folder, where the mix's driver and scene are found


def load_file(kind: str, path: Path, attribute: str):
    """`attribute` of the Python file at `path`, the file of a `kind`
    ("metric", "driver", "scene") named in BENCHMARK.json or a mix."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {path.stem!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, attribute)


def load_reader(path: Path):
    """The `read(run)` function of a metric's reader file."""
    return load_file("metric", path, "read")


def load_mix(name: str, directory: Path) -> dict:
    path = directory / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


class Bench:
    def __init__(self, data: dict, bench_dir: Path = BENCH_DIR, root: Path | None = None):
        self.data = data
        self.dir = bench_dir
        self.root = root if root is not None else bench_dir.parent
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}

    @classmethod
    def load(cls, root: Path, bench_dir: Path = BENCH_DIR) -> "Bench":
        path = Path(root) / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        return cls(json.loads(path.read_text()), bench_dir, Path(root))

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: {', '.join(self.workloads)})")
        w = self.workloads[name]
        cfg_entry = self.configs[w["config"]]
        config = json.loads((self.root / cfg_entry["file"]).read_text())
        return Cell(name=name, chips=int(w["chips"]), config=config, mix=load_mix(w["traffic"], self.dir / "traffic"),
                    dir=self.dir)

    def metrics(self, cell: Cell, trace: bool) -> list:
        """[(entry, reader)] of the cell's end-to-end metrics (trace=False)
        or per-layer metrics (trace=True), in BENCHMARK.json's order."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [(m, load_reader(self.dir / "metrics" / f"{m['name']}.py"))
                for m in group if cell.name in m.get("workloads", [cell.name])]
