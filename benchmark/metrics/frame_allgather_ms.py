"""The device time a frame of the NCCL kernels that gather the ranks'
chunks of the framebuffer for the display, on rank 0, in ms.  A rank's
collective waits for the slowest rank, so an imbalance between the row
chunks shows here too."""


def read(r):
    if r.kind != "frames" or r.trace is None:
        return None
    ms = sum(e - s for n, s, e in r.trace.device
             if "nccl" in n.lower()) / 1e3 / r.units
    return ms if ms > 0 else None
