"""Inverse rendering's first steps, as the reference takes them: the MSE
loss of a one-sample frame against a target frame, its gradient with
respect to the material tables by autograd of the plain integrator, and
Adam.  Pixels go in blocks, so the graph of a block is freed before the
next; the loss and gradients are the sums over the blocks."""

from __future__ import annotations

import torch

from .adam import Adam
from .integrator import pixels_radiance
from .scene import with_materials


def loss_and_grads(scene, params, target, frame_num, view, job, block,
                   work=None, rows=None):
    """The loss ``sum((radiance - target)^2) / (3 * rows)`` over the first
    ``rows`` pixels (all by default) and its gradients, one per entry of
    ``params``."""
    n = rows or target.shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    loss = torch.zeros((), dtype=torch.float64, device=view.device)
    for start in range(0, n, block):
        pix = torch.arange(start, min(n, start + block), device=view.device)
        rad = pixels_radiance(pix, frame_num, view,
                              with_materials(scene, leaves), job, work)
        part = torch.sum((rad - target[pix]) ** 2) / float(n * 3)
        got = torch.autograd.grad(part, list(leaves.values()),
                                  allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        loss += part.detach().to(torch.float64)
    return loss, grads


def first_steps(scene, params0, target, frames, view, job, lr, block,
                work=None, rows=None, grad_scale=None):
    """Adam steps from ``params0`` at frames ``frames``: each step's loss,
    the first step's gradients, and each parameter's change after the
    last.  ``rows`` and ``grad_scale`` ({name: factor}) plant the faults
    a sound comparison has to catch."""
    adam = Adam({k: v.clone() for k, v in params0.items()}, lr)
    losses, first = [], None
    for f in frames:
        loss, grads = loss_and_grads(scene, adam.params, target, f, view, job,
                                     block, work, rows)
        for k, s in (grad_scale or {}).items():
            grads[k] = grads[k] * s
        if first is None:
            first = grads
        adam.step(grads)
        losses.append(float(loss))
    change = {k: adam.params[k] - params0[k] for k in params0}
    return {"losses": losses, "grads": first, "change": change}
