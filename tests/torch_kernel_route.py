"""The ``kernel_route`` fixture of the port's tests: the megakernel
wrapper's CUDA route on CPU tensors, with the launch's ctypes call replaced
by a stand-in, so everything but the kernel runs as on the card.  A test
module takes it with ``from torch_kernel_route import kernel_route``.
"""

import ctypes
import types

import pytest
import torch

from tpu_path_tracer_torch.kernels import _build
from tpu_path_tracer_torch.kernels import megakernel as mk


class Launches(list):
    """The tables each launch was handed, in the forward kernel's shared
    layout sph | quad | tri | light | cam (the flat tables, then the view
    matrix the entry point takes apart); ``bvh`` holds, for each launch of
    the BVH variant, the pointers of its node and triangle rows."""

    def __init__(self):
        super().__init__()
        self.bvh = []


def _floats(ptr, n):
    return torch.frombuffer(bytearray(ctypes.string_at(ptr, 4 * n)),
                            dtype=torch.float32)


@pytest.fixture
def kernel_route(monkeypatch):
    """The route with its kernel a stand-in that writes zero radiance.
    Returns the :class:`Launches`: the tables and view matrix each launch
    was handed, copied out of the launch's pointers.  The wrapper's cache
    of packed tables starts and ends empty."""
    flats = Launches()

    def launch(flat, n_sph, n_quad, n_tri, *args):
        out, n = args[3], args[4]
        view, rows, tris = args[-4:-1]
        floats = (n_sph * mk.SPH_COLS + n_quad * mk.QUAD_COLS
                  + n_tri * mk.TRI_COLS + mk.LIGHT_COLS)
        flats.append(torch.cat([_floats(flat, floats),
                                _floats(view, mk.CAM_COLS)]))
        if rows is not None:
            flats.bvh.append((rows, tris))
        ctypes.memset(out, 0, 12 * n)
        return 0

    monkeypatch.setattr(mk, "path_trace_pixels_reference", mk._kernel_route)
    monkeypatch.setattr(_build, "load", lambda: None)
    monkeypatch.setattr(mk, "_bind", lambda lib: (launch, None, None))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    mk.clear_table_cache()
    yield flats
    mk.clear_table_cache()
