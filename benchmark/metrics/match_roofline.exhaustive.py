"""match_roofline.exhaustive: 100 x kernel 4's least time (benchmark/harness/roofline.py `match`, from the profiled calls' valid counts over the pair list) over its device time in the profiled slice."""


def read(run):
    prof = run.profile
    if prof is None or "match" not in run.bounds_s or prof.kernel_s.get("match", 0.0) <= 0:
        return None
    return 100.0 * run.bounds_s["match"] / prof.kernel_s["match"]
