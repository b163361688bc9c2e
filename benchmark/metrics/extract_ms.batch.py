"""extract_ms.batch: CUDA-event ms of `extract_batch` (upload included) per frame, over every call of the window."""


def read(run):
    ms = run.stage_ms.get("extract")
    return sum(ms) / (len(ms) * run.cell.mix["batch"]) if ms else None
