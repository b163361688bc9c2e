"""The entry "batch": a closed loop of `extract_batch` on `batch`
consecutive frames from host memory, then `match` over the batch's
consecutive pairs."""

from __future__ import annotations

from benchmark.harness import check, port
from benchmark.harness.drivers import Driver, Run
from benchmark.reference import akaze as ref_akaze
from benchmark.reference import match as ref_match


class BatchDriver(Driver):
    unit = "frames"

    def __init__(self, run: Run):
        super().__init__(run)
        self.per_call = int(self.mix["batch"])

    def frames(self, i: int):
        return self.pool[i % self.pool.shape[0], : self.per_call]

    def step(self, i: int):
        self.stages.mark()
        feats = port.extract_batch(self.frames(i), self.akaze, device=self.run.device)
        self.stages.mark("extract")
        d, v = feats.descriptors, feats.keypoints.valid
        m = port.match(d[:-1], v[:-1], d[1:], v[1:], self.mcfg, device=self.run.device)
        self.stages.mark("match")
        return check.features_of(feats), check.matches_of(m)

    def pairs_of(self, valid: list):
        """Valid counts of the A and B sides of the call's matched pairs."""
        return valid[:-1], valid[1:]

    def reference(self, lowp: bool = False) -> list:
        """The reference's (features, matches) of each sampled call."""
        out = []
        for i, _ in self.sample:
            frames = self.frames(i).to(self.run.device)
            f = ref_akaze.extract(frames, self.params, lowp=lowp)
            d, v = f["descriptors"], f["valid"]
            out.append((f, ref_match.match(d[:-1], v[:-1], d[1:], v[1:], **self.match_opts)))
        return out


DRIVER = BatchDriver
