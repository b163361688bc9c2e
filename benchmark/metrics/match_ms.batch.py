"""match_ms.batch: CUDA-event ms of `match` per matched pair, over every call of the window."""


def read(run):
    ms = run.stage_ms.get("match")
    return sum(ms) / (len(ms) * (run.cell.mix["batch"] - 1)) if ms else None
