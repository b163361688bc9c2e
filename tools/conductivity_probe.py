#!/usr/bin/env python3
"""Hold kernels 2 and 5 against their plain twins for every conductivity
(PM_G1, PM_G2, Weickert) on one GPU, and report how far apart they are.

    python3 tools/conductivity_probe.py [--batch 8]

For each diffusivity: kernel 2 (`build_scale_space` on a batch of VGA
`video_sequence` frames) and kernel 5 (`build_scale_space_levels` on one
VGA frame) against the same builders on the plain twins, both on the card.
Prints the largest ULP gap of Lt, Lx, Ly and the detect score (kernel 2) or
Ldet (kernel 5), the count of differing pixels, whether the packed
sub-pixel fields are equal, and whether `extract_batch_fn` gives the same
keypoints through the kernels as through the twins.  The Weickert rows are
printed twice: with the twin as it is (a true division in its exponent) and
with the exponent written `-3.315 / safe`, which torch runs as
reciprocal(safe) * -3.315 (then with its keypoints too).  Last, torch.exp
on the card against a float64 exp rounded to float32 on the
conductivities' own arguments.  Ends with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def ulps(torch, a, b) -> tuple[int, int]:
    """(largest ULP gap, pixels that differ) of two float32 tensors."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    # Map the sign-magnitude bit patterns onto a monotone integer line.
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    d = (ia - ib).abs()
    return int(d.max()), int((d > 0).sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()

    import torch

    from akaze_tpu_torch.core.config import AkazeConfig, Diffusivity
    from akaze_tpu_torch.frontend import scale_space
    from akaze_tpu_torch.frontend.pipeline import _statics, extract_batch_fn
    from akaze_tpu_torch.kernels import fed
    from akaze_tpu_torch.utils.synthetic import video_sequence

    if not torch.cuda.is_available():
        print("conductivity_probe: no GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    H, W = 480, 640
    frames = torch.from_numpy(video_sequence(args.batch, H, W, seed=40)).to(dev)
    true_div = scale_space.conductivity

    def reciprocal_exponent(lx, ly, k, kind):
        if kind != Diffusivity.WEICKERT:
            return true_div(lx, ly, k, kind)
        grad2 = (lx * lx + ly * ly) / (k * k)
        g2_4 = grad2 * grad2
        g2_4 = g2_4 * g2_4
        safe = torch.where(g2_4 > 0, g2_4, torch.ones_like(g2_4))
        return torch.where(grad2 > 0.0, 1.0 - torch.exp(-3.315 / safe), torch.ones_like(g2_4))

    ok = True
    for diff in (Diffusivity.PM_G1, Diffusivity.PM_G2, Diffusivity.WEICKERT):
        cfg = AkazeConfig(diffusivity=diff)
        ss, _ = _statics(W, H, cfg)
        twins = [("twin", true_div)]
        if diff == Diffusivity.WEICKERT:
            twins.append(("twin with reciprocal exponent", reciprocal_exponent))
        got2 = fed.build_scale_space(frames, ss)
        got5 = fed.build_scale_space_levels(frames[:1], ss)
        for label, cond in twins:
            fed.conductivity = cond
            try:
                ref2 = fed.build_scale_space(frames, ss, plain=True)
                ref5 = fed.build_scale_space_levels(frames[:1], ss, plain=True)
            finally:
                fed.conductivity = true_div
            parts = []
            for key in ("Lt", "Lx", "Ly"):
                gaps = [ulps(torch, g[key], r[key]) for g, r in zip(got2["lvl_oct"], ref2["lvl_oct"])]
                parts.append(f"{key} {max(u for u, _ in gaps)} ULP / {sum(n for _, n in gaps)} px")
            sc = [ulps(torch, g["score"], r["score"]) for g, r in zip(got2["oct"], ref2["oct"])]
            parts.append(f"score {max(u for u, _ in sc)} ULP / {sum(n for _, n in sc)} px")
            sub_eq = all(torch.equal(g["sub"], r["sub"]) for g, r in zip(got2["oct"], ref2["oct"]))
            l5 = {key: ulps(torch, got5[key], ref5[key]) for key in ("Lt", "Lx", "Ly", "Ldet")}
            equal = (all("0 ULP" in p for p in parts) and sub_eq
                     and all(u == 0 for u, _ in l5.values()))
            print(f"{diff.value} ({label}): kernel 2, batch {args.batch} VGA: {', '.join(parts)}, sub "
                  f"{'equal' if sub_eq else 'DIFFERENT'}; kernel 5, one VGA frame: "
                  + ", ".join(f"{k} {u} ULP / {n} px" for k, (u, n) in l5.items())
                  + f" -> {'bit-equal' if equal else 'NOT bit-equal'}", flush=True)
            if label == "twin":
                ok &= equal
            else:
                fed.conductivity = cond
                try:
                    fp = extract_batch_fn(frames, cfg, plain=True)
                finally:
                    fed.conductivity = true_div
                fk = extract_batch_fn(frames, cfg)
                same = (torch.equal(fk.keypoints.valid, fp.keypoints.valid)
                        and torch.equal(fk.keypoints.x, fp.keypoints.x) and torch.equal(fk.keypoints.y, fp.keypoints.y))
                moved = int((fk.keypoints.x != fp.keypoints.x).sum() + (fk.keypoints.y != fp.keypoints.y).sum())
                print(f"{diff.value} ({label}): extract_batch_fn keypoints {fk.keypoints.count().tolist()} "
                      f"through the kernels, {fp.keypoints.count().tolist()} through this twin: "
                      f"{'equal' if same else f'DIFFERENT ({moved} coordinates differ)'}, descriptors "
                      f"{'equal' if torch.equal(fk.descriptors, fp.descriptors) else 'DIFFERENT'}", flush=True)
        fk = extract_batch_fn(frames, cfg)
        fp = extract_batch_fn(frames, cfg, plain=True)
        same = (torch.equal(fk.keypoints.valid, fp.keypoints.valid) and torch.equal(fk.keypoints.x, fp.keypoints.x)
                and torch.equal(fk.keypoints.y, fp.keypoints.y) and torch.equal(fk.descriptors, fp.descriptors))
        print(f"{diff.value}: extract_batch_fn keypoints {fk.keypoints.count().tolist()} through the kernels, "
              f"{fp.keypoints.count().tolist()} through the twins: {'equal' if same else 'DIFFERENT'}", flush=True)
        ok &= same

    # torch.exp on the card against exp in float64 rounded to float32, on
    # arguments spread over the conductivities' range.
    x = -torch.logspace(-8, 2, 4_000_000, device=dev, dtype=torch.float32)
    u, n = ulps(torch, torch.exp(x), torch.exp(x.double()).float())
    print(f"torch.exp (CUDA, float32) against float64 exp rounded: {u} ULP, {n} of {x.numel()} values differ",
          flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
