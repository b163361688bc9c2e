"""kernels_roofline: 100 x the summed least times of the port's kernels 1-4 over their summed device time in the profiled slice."""


def read(run):
    prof = run.profile
    if prof is None:
        return None
    timed = [k for k in run.bounds_s if prof.kernel_s.get(k, 0.0) > 0]
    busy = sum(prof.kernel_s[k] for k in timed)
    return 100.0 * sum(run.bounds_s[k] for k in timed) / busy if busy > 0 else None
