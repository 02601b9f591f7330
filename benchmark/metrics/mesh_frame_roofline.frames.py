"""A mesh frame's share of its roofline: the least time of the whole
frame's work (``reference.work_mesh``, from the work the reference traced)
over the device time a frame of every kernel the frame launched, the
display's included (copies, the display's to the host among them, and
fills are not kernels), in %."""


def read(r):
    if (r.kind != "frames" or r.trace is None
            or "mesh_frame" not in r.bounds):
        return None
    ms = sum(e - s for _, s, e in r.trace.kernels()) / 1e3 / r.units
    if ms <= 0:
        return None
    return 100.0 * r.bounds["mesh_frame"] / ms
