"""setup_s: process start to the first timed call (imports, kernel build or load, frames made, warm-up)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
