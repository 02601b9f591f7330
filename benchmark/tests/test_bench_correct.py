"""``correct`` at a small size on the CPU: every cell proves correct when
the program is sound; the control (the reference in bfloat16 in the
program's place) fails a number of each cell; and each fault a cell can
have, planted under the timed path, turns ``correct`` false.  (One card
has no exchange between chips to leave out.)"""

import pytest
import torch

from benchmark import harness

from .conftest import CELLS, tiny

import tpu_path_tracer_torch.dist.render_dist as rd
from tpu_path_tracer_torch.integrator import film

SEED = 2 ** 31 + 3


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell, trace):
    out = harness.run_cell(cell, SEED, 0.2, trace, "cpu",
                           overrides=tiny(cell), say=lambda _: None)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    cell_spec, job = harness.make_job(cell, SEED, "cpu",
                                      overrides=tiny(cell))
    job.setup()
    job.window(seconds=0.2, spans=harness._no_span)
    job.release()
    limits = cell_spec["limits"]
    readings = job.control_readings()
    for name, numbers in readings.items():
        if name == "fault_grad_altered":
            continue  # Adam's step ignores the scale: grad_gap alone sees it
        over = [k for k, v in numbers.items() if v > limits[k]]
        assert over, (name, numbers, limits)


# Faults planted under the timed path ---------------------------------


def _frozen_step(mesh, base_scene, meta, cfg, apply_params, optimizer):
    """A step that returns its state unchanged: no update."""
    loss_fn = rd.make_sharded_loss_fn(mesh, base_scene, meta, cfg,
                                      apply_params)

    def step(params, target, frame_num, view):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target, frame_num, view)
        loss.backward()
        return loss.detach()

    return step


def _half_loss(mesh, base_scene, meta, cfg, apply_params):
    """Half of the pixels left out, the mean taken over the rest."""

    def loss(params, target, frame_num, view):
        n = target.shape[0] // 2
        rad = rd._pixel_radiance(torch.arange(n, device=target.device),
                                 frame_num, rd._view(view, target.device),
                                 apply_params(base_scene, params), meta, cfg)
        return torch.sum((rad - target[:n]) ** 2) / float(n * 3)

    return loss


def _scaled(factor):
    orig = rd.path_trace_pixels

    def trace(*args):
        state, rad = orig(*args)
        return state, rad * factor

    return trace


def _half_traced():
    orig = rd.path_trace_pixels

    def trace(*args):
        state, rad = orig(*args)
        rad = rad.clone()
        rad[rad.shape[0] // 2:] = 0.0
        return state, rad

    return trace


def _shown_brighter(img01):
    return torch.clamp(torch.round(img01 * 255.0) + 2, 0, 255).to(
        torch.uint8)


TRAIN_FAULTS = {
    "state_unchanged": [(rd, "make_train_step", _frozen_step)],
    "half_batch": [(rd, "make_sharded_loss_fn", _half_loss)],
    "answer_altered": [(rd, "path_trace_pixels", _scaled(1.25))],
}
FRAME_FAULTS = {
    "state_unchanged": [(film, "accumulate", lambda fb, rad, reset: fb)],
    "half_batch": [(rd, "path_trace_pixels", _half_traced())],
    "answer_altered": [(rd, "path_trace_pixels", _scaled(1.25))],
    "display_altered": [(film, "to_uint8", _shown_brighter)],
}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in (TRAIN_FAULTS if c.endswith("train") else FRAME_FAULTS)])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault,
                                                     monkeypatch):
    faults = TRAIN_FAULTS if cell.endswith("train") else FRAME_FAULTS
    for module, attr, value in faults[fault]:
        monkeypatch.setattr(module, attr, value)
    out = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                           overrides=tiny(cell))
    assert not out["correct"], out["checks"]
