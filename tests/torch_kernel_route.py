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


@pytest.fixture
def kernel_route(monkeypatch):
    """The route with its kernel a stand-in that writes zero radiance.
    Returns the list of the flat tables each launch was handed, copied out
    of the launch's pointer.  The wrapper's cache of packed tables starts
    and ends empty."""
    flats = []

    def launch(flat, n_sph, n_quad, n_tri, *args):
        out, n = args[3], args[4]
        floats = (n_sph * mk.SPH_COLS + n_quad * mk.QUAD_COLS
                  + n_tri * mk.TRI_COLS + mk.LIGHT_COLS + mk.CAM_COLS)
        flats.append(torch.frombuffer(bytearray(ctypes.string_at(
            flat, 4 * floats)), dtype=torch.float32))
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
