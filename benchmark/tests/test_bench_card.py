"""On the card, at each cell's own sizes: a short run proves correct, and
the control (the reference in bfloat16 in the program's place) fails a
number of the cell.  Skips without a card; on one::

    python -m pytest benchmark/tests/test_bench_card.py -o addopts="" -q
"""

import pytest

from benchmark import harness

from .conftest import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    spec, job = harness.make_job(cell, 2 ** 31 + 77, card)
    job.setup()
    job.window(seconds=2.0, spans=harness._no_span)
    job.release()
    numbers, bounds = job.check()
    limits = spec["limits"]
    assert all(v <= limits[k] for k, v in numbers.items()), numbers
    assert all(0 < b for b in bounds.values())
    control = job.control_readings()["control_bf16"]
    assert any(v > limits[k] for k, v in control.items()), control
