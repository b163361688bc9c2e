"""extract_ms.live: CUDA-event ms of `extract` (B = 1, upload included) per frame, over every frame of the window."""


def read(run):
    ms = run.stage_ms.get("extract")
    return sum(ms) / len(ms) if ms else None
