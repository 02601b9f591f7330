"""CUDA kernels launched a train step (copies and fills are not
kernels), from the profile of the traced window."""


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    return len(r.trace.kernels()) / r.units
