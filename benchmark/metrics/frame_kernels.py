"""CUDA kernels launched a frame, the display's included (copies and
fills are not kernels), from the profile of the traced window."""


def read(r):
    if r.kind != "frames" or r.trace is None:
        return None
    return len(r.trace.kernels()) / r.units
