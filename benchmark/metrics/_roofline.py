"""A kernel's share of its roofline: the least time of a launch on these
inputs (``reference.work``, from the work the reference traced) over the
device time the profile gives the kernel's launches, a launch."""


def share(r, kind, bound_key, names):
    if r.kind != kind or r.trace is None or bound_key not in r.bounds:
        return None
    ms = sum(e - s for n, s, e in r.trace.device
             if any(k in n for k in names)) / 1e3 / r.units
    if ms <= 0:
        return None
    return 100.0 * r.bounds[bound_key] / ms
