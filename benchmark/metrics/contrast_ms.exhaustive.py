"""contrast_ms.exhaustive: ms per view in the port's `frontend.contrast` spans (the contrast factor's percentile bincount; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.contrast") or not run.calls:
        return None
    return spans.ms("frontend.contrast") / (run.calls * run.cell.mix["views"])
