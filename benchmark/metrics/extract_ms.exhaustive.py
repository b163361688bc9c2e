"""extract_ms.exhaustive: ms per view in the port's `frontend.extract` spans (the whole of `extract_batch`, upload included; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.extract") or not run.calls:
        return None
    return spans.ms("frontend.extract") / (run.calls * run.cell.mix["views"])
