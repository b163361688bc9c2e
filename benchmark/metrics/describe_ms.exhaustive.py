"""describe_ms.exhaustive: ms per view in the port's `frontend.describe` spans (kernel 3 and its dispatch; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.describe") or not run.calls:
        return None
    return spans.ms("frontend.describe") / (run.calls * run.cell.mix["views"])
