"""upload_ms.exhaustive: ms per view in the port's `frontend.upload` spans (the views' host -> device copy and uint8 -> float32; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.upload") or not run.calls:
        return None
    return spans.ms("frontend.upload") / (run.calls * run.cell.mix["views"])
