"""ransac_ms.pairs: CUDA-event ms of `estimate_relative_pose` per call, over every call of the window."""


def read(run):
    ms = run.stage_ms.get("ransac")
    return sum(ms) / len(ms) if ms else None
