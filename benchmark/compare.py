"""The numbers that decide ``correct``, each computed from the program's
readings and the reference's.

Frames: ``frame_err``, the L1 distance of the frames' framebuffer
increments from the reference's, over the L1 size of the reference's; and
``display_err``, the share of displayed 8-bit channel values that differ
from the reference's display of the program's own framebuffer.

Training: ``loss_gap``, the largest relative gap of a step's loss;
``grad_gap`` and ``change_gap``, the largest gap between a leaf's norm in
the program and in the reference (the first step's gradient; the change
of the parameters over the first steps), over the larger of the
reference's norm of that leaf and of the median leaf.  The change leaves
out leaves whose reference gradient is nought to rounding: under a
thousandth of the median of the leaves' nonzero gradient norms (under
Adam such a leaf moves by rounding alone).
"""

from __future__ import annotations

import statistics

import torch


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.detach().to(torch.float64)))


def leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's gap, as ``leaf_gap`` takes the largest."""
    ref_n = {k: _norm(ref[k]) for k in keys}
    med = statistics.median(ref_n.values()) if ref_n else 0.0
    return {k: abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med)
            if max(ref_n[k], med) > 0 else abs(_norm(prog[k]))
            for k in keys}


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    return max(leaf_gaps(prog, ref, list(keys)).values(), default=0.0)


def moving_leaves(ref_grads: dict) -> list:
    norms = {k: _norm(g) for k, g in ref_grads.items()}
    nonzero = [v for v in norms.values() if v > 0]
    if not nonzero:
        return []
    floor = 1e-3 * statistics.median(nonzero)
    return [k for k, v in norms.items() if v > 0 and v >= floor]


def train_numbers(prog: dict, ref: dict) -> dict:
    losses = [abs(a - b) / abs(b) if b else abs(a)
              for a, b in zip(prog["losses"], ref["losses"])]
    return {"loss_gap": max(losses),
            "grad_gap": leaf_gap(prog["grads"], ref["grads"], ref["grads"]),
            "change_gap": leaf_gap(prog["change"], ref["change"],
                                   moving_leaves(ref["grads"]))}


class FrameTally:
    """Sums over the checked frames of ``frame_err``'s numerator and
    denominator and of ``display_err``'s counts."""

    def __init__(self):
        self.diff = self.size = 0.0
        self.bad = self.values = 0

    def add(self, d_prog, d_ref, img_prog, img_ref):
        self.diff += float(torch.sum(torch.abs(
            d_prog.to(torch.float64) - d_ref.to(torch.float64))))
        self.size += float(torch.sum(torch.abs(d_ref.to(torch.float64))))
        self.bad += int(torch.count_nonzero(img_prog != img_ref))
        self.values += img_ref.numel()

    def numbers(self) -> dict:
        return {"frame_err": self.diff / self.size if self.size else 0.0,
                "display_err": self.bad / max(self.values, 1)}
