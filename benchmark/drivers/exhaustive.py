"""The entry "exhaustive": a closed loop over sets of `views` stills from
host memory: `extract_batch` on the whole set, then `match` of every pair
of the set (all i < j, in row-major order) in one call through a pair
table, as a photogrammetry front end matches a photo collection.

The check compares every view of each sampled call with the reference
extractor (run in blocks of `reference_block` views, so that it fits
beside the sample) and `checked_pairs` of the pair list with the reference
matcher: always (0, 1) and (0, views // 2), the view opposite the first on
the orbit, and the others drawn from the seed.

The cell is held to the frame and the pool it runs on: a set holds at
most the pool's `sequence_frames` views, and the pan stays inside the
scene (at most half the frame each way).  Where the camera is smaller than
the configuration file's own, as a CPU test makes it, the capacities shrink
with the frame's area, so that keypoints and candidates per pixel stay the
file's.  At the file's own frame and the mix's own pool nothing changes."""

from __future__ import annotations

import dataclasses
import inspect
import json
import random

import torch

from benchmark.harness import check, port
from benchmark.harness.drivers import Driver, Run
from benchmark.reference import akaze as ref_akaze
from benchmark.reference import pairs as ref_pairs


def fitted(cell):
    """The cell held to its frame and pool (see the module's docstring)."""
    cam, mix = cell.config["camera"], dict(cell.mix)
    mix["views"] = min(int(mix["views"]), int(mix["sequence_frames"]))
    mix["pan"] = {"x_px": min(mix["pan"]["x_px"], int(cam["width"]) // 2),
                  "y_px": min(mix["pan"]["y_px"], int(cam["height"]) // 2)}
    own = json.loads((cell.dir / "configs" / f"{cell.config['name']}.json").read_text())["camera"]
    px, own_px = int(cam["width"]) * int(cam["height"]), int(own["width"]) * int(own["height"])
    if px >= own_px:
        return dataclasses.replace(cell, mix=mix)
    akaze = dict(cell.config["akaze"])
    for key in ("max_keypoints", "per_level_candidates"):
        akaze[key] = max(1, akaze[key] * px // own_px)
    return dataclasses.replace(cell, config={**cell.config, "akaze": akaze}, mix=mix)


class ExhaustiveDriver(Driver):
    unit = "frames"

    def __init__(self, run: Run):
        if "pairs" not in inspect.signature(port.match).parameters:
            raise TypeError("exhaustive: the program's match takes no pair table (pairs=...)")
        run.cell = fitted(run.cell)
        super().__init__(run)
        if self.mix["pair_mode"] != "exhaustive":
            raise ValueError(f"exhaustive: unknown pair_mode {self.mix['pair_mode']!r}")
        self.per_call = int(self.mix["views"])
        if self.per_call < 2:
            raise ValueError("exhaustive: a set needs at least 2 views")
        self.pair_list = ref_pairs.exhaustive(self.per_call)
        self.table = torch.tensor(self.pair_list, dtype=torch.int32)
        self.block = int(self.mix["reference_block"])
        always = list(dict.fromkeys(self.pair_list.index(p) for p in ((0, 1), (0, self.per_call // 2))))
        rest = [p for p in range(len(self.pair_list)) if p not in always]
        n = max(0, min(int(self.mix["checked_pairs"]), len(self.pair_list)) - len(always))
        self.checked = sorted(always + random.Random(run.seed).sample(rest, n))

    def frames(self, i: int):
        return self.pool[i % self.pool.shape[0], : self.per_call]

    def step(self, i: int):
        dev = self.run.device
        feats = port.extract_batch(self.frames(i), self.akaze, device=dev)
        d, v = feats.descriptors, feats.keypoints.valid
        m = port.match(d, v, d, v, self.mcfg, device=dev, pairs=self.table)
        return check.features_of(feats), check.matches_of(m)

    def pairs_of(self, valid: list):
        """Valid counts of the A and B sides of each pair of the list."""
        return [valid[i] for i, _ in self.pair_list], [valid[j] for _, j in self.pair_list]

    def reference(self, lowp: bool = False) -> list:
        """The reference's (features of every view, matches of the checked
        pairs) of each sampled call."""
        out = []
        chosen = [self.pair_list[p] for p in self.checked]
        for i, _ in self.sample:
            f = ref_akaze.extract(self.frames(i).to(self.run.device), self.params, lowp=lowp, block=self.block)
            d, v = f["descriptors"], f["valid"]
            out.append((f, ref_pairs.match(d, v, d, v, chosen, **self.match_opts)))
        return out

    def outputs(self) -> list:
        """The program's (features, matches of the checked pairs) of each
        sampled call, as `reference` gives the reference's."""
        out = []
        for _, (feats, m) in self.sample:
            rows = torch.tensor(self.checked, dtype=torch.long, device=m["idx_b"].device)
            out.append((feats, {key: t[rows] for key, t in m.items()}))
        return out

    def numbers(self, outputs: list, refs: list) -> dict:
        per = {"keypoints_off": [], "descriptor_bits_off": [], "matches_off": []}
        for got, ref in zip(outputs, refs):
            kp, desc = check.features_off(got[0], ref[0], chunk=self.block)
            per["keypoints_off"] += kp
            per["descriptor_bits_off"] += desc
            per["matches_off"] += check.matches_off(got[1], ref[1])
        return check.worst(per)


DRIVER = ExhaustiveDriver
