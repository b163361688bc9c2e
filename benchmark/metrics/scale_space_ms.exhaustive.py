"""scale_space_ms.exhaustive: ms per view in the port's `frontend.scale_space` spans (kernel 1 and kernel 2's octaves, without the contrast factor; CUDA events of utils.profiling.span, less the `frontend.contrast` spans inside), over every call of the window."""


def read(run):
    spans = run.spans
    if spans is None or not spans.count("frontend.scale_space") or not run.calls:
        return None
    return spans.self_ms("frontend.scale_space") / (run.calls * run.cell.mix["views"])
