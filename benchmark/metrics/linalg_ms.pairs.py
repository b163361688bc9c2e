"""linalg_ms.pairs: ms per call in the port's own `linalg` spans (CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    if run.spans is None or not run.spans.count("linalg") or not run.calls:
        return None
    return run.spans.ms("linalg") / run.calls
