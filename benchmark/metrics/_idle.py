"""The device's idle share of the traced window: 1 less the union of its
operations' intervals over the window's length, in %."""


def idle_pct(r, kind):
    if r.kind != kind or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
