"""detect_ms.exhaustive: ms per view in the port's `frontend.detect` spans (cross-level NMS, top-M and sub-pixel refinement; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.detect") or not run.calls:
        return None
    return spans.ms("frontend.detect") / (run.calls * run.cell.mix["views"])
