"""candidates_ms.exhaustive: ms per view in the port's `frontend.candidates` spans (the per-level exact top-K; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.candidates") or not run.calls:
        return None
    return spans.ms("frontend.candidates") / (run.calls * run.cell.mix["views"])
