"""match_ms.exhaustive: ms per matched pair in the port's `matching.match` spans (pair table, kernel 4 and the filters; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("matching.match") or not run.calls:
        return None
    views = run.cell.mix["views"]
    return spans.ms("matching.match") / (run.calls * views * (views - 1) // 2)
