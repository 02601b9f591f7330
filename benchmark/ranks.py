"""A cell on several cards: one rank a card, all on this host.

``launch`` starts ``world`` processes (the ``spawn`` start method), one a
rank, as the program's own ``render --devices n`` does: rank r takes card
r (``LOCAL_RANK``) and joins the program's process group through its
``init_distributed`` (NCCL between cards; gloo with ``device="cpu"``,
which the tests use), and the run's ``DeviceMesh`` over every rank is
handed to the program.  Beside it the benchmark keeps a host-side gloo
group of its own (``Group``): rank 0 passes its decisions to the others
over it (``agree``: when the window ends, which frames are kept), and the
ranks' sums and facts meet there at the end.

The launcher (``torch.multiprocessing.start_processes``) waits for every
rank.  When one fails, it ends the others and reports the failure; ranks
that outlive ``DEADLINE_S`` are ended too.  Only rank 0's return value
comes back.
"""

from __future__ import annotations

import datetime
import functools
import multiprocessing
import os
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import harness, system

# How long a rank of the benchmark's own group waits for the others: the
# reference's check of one rank may end well after another's.
GROUP_TIMEOUT = datetime.timedelta(seconds=900)
# The ranks of a run are ended after this long: a run that builds the
# kernels may take 1200 s, any other 360.
DEADLINE_S = 1100


class Group:
    """This rank's place in a multi-card run: the program's mesh and the
    benchmark's host-side gloo group."""

    def __init__(self, rank, world, mesh, place, device):
        self.rank, self.world, self.mesh = rank, world, mesh
        self.place = place    # the card, LOCAL_RANK
        self.device = device  # where this rank keeps its tensors
        self.control = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
        self.agree_s = 0.0    # host seconds spent in agree
        self.agreed = 0

    def agree(self, *flags):
        """Rank 0's ``flags`` (booleans), on every rank."""
        t0 = time.perf_counter()
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.broadcast(t, src=0, group=self.control)
        self.agree_s += time.perf_counter() - t0
        self.agreed += 1
        return tuple(bool(v) for v in t.tolist())

    def total(self, values):
        """The sums over the ranks of ``values`` (numbers), in float64."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        dist.all_reduce(t, group=self.control)
        return t.tolist()

    def gather(self, obj):
        """Every rank's ``obj`` in rank order, on rank 0; None elsewhere."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.control)
        return out

    def rows(self, x):
        """Every rank's tensor ``x`` (on the host), in rank order."""
        x = x.detach().cpu().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self.control)
        return parts

    def from_lead(self, parts, like):
        """Rank 0's ``parts[r]`` on each rank r (each shaped as ``like``);
        other ranks pass None."""
        out = torch.empty_like(like)
        dist.scatter(out, parts, src=0, group=self.control)
        return out

    def barrier(self):
        dist.barrier(group=self.control)

    def identity(self) -> str:
        """The device this rank ran on: a card by its UUID; on the CPU
        (the tests) the place the rank was given."""
        if self.device.type == "cuda":
            return str(torch.cuda.get_device_properties(self.device).uuid)
        return f"cpu:{self.place}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device, places, body, args, out):
    os.environ["LOCAL_RANK"] = str(places[rank])
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    mesh, rank_device = system.join_ranks(f"127.0.0.1:{port}", world, rank,
                                          device)
    try:
        group = Group(rank, world, mesh, places[rank], rank_device)
        value = body(group, *args)
        if rank == 0:
            out.put(value)
    finally:
        dist.destroy_process_group()


def launch(body, args, world, device="cuda", places=None):
    """Run ``body(group, *args)`` on ``world`` ranks; ``places[r]`` is
    rank r's card (default r).  On the cards the program's kernels are
    built here first, once, as its ``render --devices`` does.  Returns
    (exit code, rank 0's value): 0 when every rank ended cleanly, 1 when
    one failed (the others are ended, the value is None), 124 when the
    ranks outlived ``DEADLINE_S``."""
    places = list(range(world)) if places is None else list(places)
    if device == "cuda":
        system.build_kernels()
    out = multiprocessing.get_context("spawn").SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(world, _free_port(), device, places, body, args,
                          out),
        nprocs=world, join=False, daemon=True, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    value = []
    try:
        while not procs.join(timeout=0.5):
            # Read as it comes: a large value fills the pipe.
            if not value and not out.empty():
                value.append(out.get())
            if time.monotonic() > end:
                print(f"benchmark: the ranks outlived {DEADLINE_S} s",
                      file=sys.stderr)
                return 124, None
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"benchmark: {e}\nbenchmark: the other ranks were ended",
              file=sys.stderr)
        return 1, None
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join()
    if not value and not out.empty():
        value.append(out.get())
    return 0, value[0] if value else None


def _run_cell(group, *args):
    return harness.run_cell(*args, group=group)


def run_cell(name, seed, seconds, trace, world, t_start, device="cuda",
             places=None, base=harness.HERE, root=harness.ROOT,
             overrides=None):
    """``harness.run_cell`` on ``world`` ranks.  Returns (exit code, rank
    0's line): not 0, and no line, when a rank failed, when a rank holds a
    module the port must not load, or when the ranks ran on fewer distinct
    devices than ``world``."""
    say = functools.partial(print, flush=True)
    code, out = launch(_run_cell, (
        name, seed, seconds, trace, device, t_start, base, root, overrides,
        say), world, device, places)
    if code:
        return code, None
    found = sorted({m for r in out["ranks"] for m in r["forbidden"]})
    if found:
        print(f"benchmark: a rank holds {found}, which the port must not "
              f"load", file=sys.stderr)
        return 3, None
    if out["device"]["count"] < world:
        print(f"benchmark: the {world} ranks ran on "
              f"{out['device']['count']} distinct device(s)",
              file=sys.stderr)
        return 2, None
    return 0, out
