"""refit_ms.pairs: ms per call in the port's `geometry.refit` spans (the beam's three guarded QR -> SVD refits, their `linalg` spans included; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("geometry.refit") or not run.calls:
        return None
    return spans.ms("geometry.refit") / run.calls
