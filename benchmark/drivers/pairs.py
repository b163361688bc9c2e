"""The entry "pairs": a closed loop of `extract_batch` on 2 * `pairs`
frames, `match` of each even frame to the next, the correspondences
normalized with the camera's intrinsics, and `estimate_relative_pose` on
scores drawn from the seed, the same draws for the program and the
reference."""

from __future__ import annotations

import torch

from benchmark.harness import check, port
from benchmark.harness.drivers import Driver, Run
from benchmark.reference import akaze as ref_akaze
from benchmark.reference import match as ref_match
from benchmark.reference import twoview as ref_twoview
from benchmark.traffic import generator


class PairsDriver(Driver):
    unit = "pairs"

    def __init__(self, run: Run):
        super().__init__(run)
        self.per_call = int(self.mix["pairs"])
        cam = self.camera
        self.intrinsics = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        self.draws = generator.draws(self.mix, int(self.akaze.max_keypoints), run.seed, run.device)

    def frames(self, i: int):
        return self.pool[i % self.pool.shape[0], : 2 * self.per_call]

    def scores(self, i: int):
        return self.draws[i % self.draws.shape[0]]

    def step(self, i: int):
        dev = self.run.device
        self.stages.mark()
        feats = port.extract_batch(self.frames(i), self.akaze, device=dev)
        self.stages.mark("extract")
        kp, d = feats.keypoints, feats.descriptors
        m = port.match(d[0::2], kp.valid[0::2], d[1::2], kp.valid[1::2], self.mcfg, device=dev)
        self.stages.mark("match")
        idx = m.idx_b.long()
        x1 = port.normalize_points(kp.x[0::2], kp.y[0::2], self.intrinsics)
        x2 = port.normalize_points(torch.gather(kp.x[1::2], 1, idx), torch.gather(kp.y[1::2], 1, idx),
                                   self.intrinsics)
        pose = port.estimate_relative_pose(x1, x2, m.accepted, self.rcfg, device=dev, sample_scores=self.scores(i))
        self.stages.mark("ransac")
        return (check.features_of(feats), check.matches_of(m),
                {"R": pose.R, "t": pose.t, "num_inliers": pose.num_inliers})

    def pairs_of(self, valid: list):
        return valid[0::2], valid[1::2]

    def reference(self, lowp: bool = False) -> list:
        out = []
        rp = ref_twoview.RansacParams(**self.mix["ransac"])
        for i, _ in self.sample:
            f = ref_akaze.extract(self.frames(i).to(self.run.device), self.params, lowp=lowp)
            d, v = f["descriptors"], f["valid"]
            m = ref_match.match(d[0::2], v[0::2], d[1::2], v[1::2], **self.match_opts)
            x1, x2, mask = ref_twoview.correspondences(f["x"][0::2], f["y"][0::2], f["x"][1::2], f["y"][1::2],
                                                       m["idx_b"], m["accepted"], self.intrinsics)
            pose = ref_twoview.relative_pose(x1, x2, mask, self.scores(i), rp)
            out.append((f, m, {"R": pose.R, "t": pose.t, "num_inliers": pose.num_inliers}))
        return out

    def numbers(self, outputs: list, refs: list) -> dict:
        worst = super().numbers(outputs, refs)
        per = {"rotation_gap_deg": [], "translation_gap_deg": [], "inliers_off": []}
        for got, ref in zip(outputs, refs):
            for name, values in check.poses_off(got[2], ref[2]).items():
                per[name] += values
        worst.update(check.worst(per))
        return worst


DRIVER = PairsDriver
