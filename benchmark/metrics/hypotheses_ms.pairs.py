"""hypotheses_ms.pairs: ms per call in the port's `geometry.hypotheses` spans (the 8-point hypotheses, their Sampson scores and the beam's top-K; CUDA events of utils.profiling.span), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("geometry.hypotheses") or not run.calls:
        return None
    return spans.ms("geometry.hypotheses") / run.calls
