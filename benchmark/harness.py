"""The benchmark's runner: one cell, one seed, one result line.

A cell (``cells/<name>.json``) names a configuration
(``configs/<name>.json``: the scene recipe of ``scenes/<recipe>.py`` and
the camera) and a traffic mix (``traffic/<name>.json``: the job of
``jobs/<job>.py`` and its sizes).  The per-layer metrics are the readers
``metrics/<name>.py`` of the ``per_layer`` entries of ``BENCHMARK.json``
that list the cell.  Nothing here names a cell, a configuration or a
metric: a later one is added by adding its files.

A run: set-up (``setup_s`` runs from the process's start to the first
timed step); the window of ``seconds``; with ``trace`` the benchmark's
spans on the host's clock in that window, then ``trace_units`` steps under
a profile of the device alone (its end-to-end numbers against the first
window's are the tracing's overhead) and ``trace_units_host`` steps under
a profile of the host too (``profile_reduce``); the device's memory peak;
the reference's check of what the window produced; the line.

A cell whose ``chips`` is n > 1 runs on n ranks, one process a card, all
started by ``ranks.launch`` (``run.py``), each running ``run_cell`` with
its ``ranks.Group``: the program gets the run's mesh, every rank steps and
displays the same frames in lockstep, and rank 0 alone decides when the
window ends and which frames are kept (``Context.agree``).  A barrier ends
set-up on every rank, so ``setup_s`` runs from the launcher's start to the
first timed frame.  The traced phases run the same frames on every rank;
every rank profiles its device (``busy_s`` and ``window_s`` are the ranks'
mean), and rank 0 alone profiles the host and reads the metrics.  Each
rank checks its own rows, the tallies are summed over the ranks, and rank
0 returns the line with every rank's facts; the others return None.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import profile_reduce

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level modules the process must not hold once the window has closed:
# JAX and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_path_tracer")


def load(kind: str, name: str, base: Path = HERE) -> dict:
    with open(base / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spans:
    """The benchmark's spans around its calls into the program: each a
    ``torch.profiler`` annotation when ``profiled`` and a duration on the
    host's clock."""

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.durations = {}

    @contextlib.contextmanager
    def __call__(self, name):
        note = (torch.profiler.record_function(name) if self.profiled
                else contextlib.nullcontext())
        with note:
            t0 = time.perf_counter()
            yield
            self.durations.setdefault(name, []).append(
                time.perf_counter() - t0)


@contextlib.contextmanager
def _no_span(name):
    yield


class Context:
    """What a job gets: the cell's files, its scene's description, the
    seed, the device, and on several ranks this rank's ``ranks.Group``
    (``group``, whose ``mesh`` the program gets; None in one process)."""

    def __init__(self, cell, config, traffic, seed, device, base=HERE,
                 group=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = seed
        self.group = group
        self.mesh = None if group is None else group.mesh
        self.rank = 0 if group is None else group.rank
        self.device = torch.device(device) if group is None else group.device
        recipe = load_module(base / "scenes" / f"{config['recipe']}.py",
                             f"benchmark.scenes.{config['recipe']}")
        self.desc = recipe.describe(config.get("recipe_args", {}))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def agree(self, *flags):
        """Rank 0's ``flags`` on every rank; one process keeps its own."""
        return flags if self.group is None else self.group.agree(*flags)

    def total(self, values):
        """``values`` summed over the ranks; one process keeps its own."""
        return values if self.group is None else self.group.total(values)


def make_job(name, seed, device, base=HERE, overrides=None, group=None):
    cell = load("cells", name, base)
    config = load("configs", cell["config"], base)
    traffic = dict(load("traffic", cell["traffic"], base), **(overrides or {}))
    ctx = Context(cell, config, traffic, seed, device, base, group)
    mod = load_module(base / "jobs" / f"{traffic['job']}.py",
                      f"benchmark.jobs.{traffic['job']}")
    return cell, mod.Job(ctx)


def per_layer_readers(name, base=HERE, root=ROOT):
    """The readers of the per-layer metrics that list cell ``name`` (or
    list no cells)."""
    with open(root / "BENCHMARK.json") as f:
        entries = json.load(f)["per_layer"]
    out = []
    for m in entries:
        if name in m.get("workloads", [name]):
            out.append((m, load_module(base / "metrics" / f"{m['name']}.py",
                                       f"benchmark.metrics.{m['name']}")))
    return out


class Reading:
    """What a reader sees of a traced run."""

    def __init__(self, kind, units, trace, spans, bounds):
        self.kind = kind      # the job's KIND
        self.units = units    # steps or frames in the device profile
        self.trace = trace    # its profile_reduce.Trace; None on the CPU
        self.spans = spans    # span name -> host seconds, untraced window
        self.bounds = bounds  # kernel name -> least ms of a launch


def device_facts(device, memory_peak):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak)}


def ranks_facts(device, ranks):
    """``device`` facts of a multi-card run from every rank's: the
    distinct devices the ranks ran on, the largest rank's peak."""
    facts = device_facts(device, max(r["memory_peak_bytes"] for r in ranks))
    facts["count"] = len({r["device"] for r in ranks})
    return facts


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name, seed, seconds, trace, device="cuda", t_start=None,
             base=HERE, root=ROOT, overrides=None, say=print, group=None):
    """Run one cell; returns the result line's dict (``checks`` last).
    ``say`` prints a line that goes before the result.  With ``group``
    this process is one rank of a multi-card run, and only rank 0 returns
    the line (see the module's docstring)."""
    t_start = time.perf_counter() if t_start is None else t_start
    lead = group is None or group.rank == 0
    cell, job = make_job(name, seed, device, base, overrides, group)
    dev = job.ctx.device
    job.setup()
    job.ctx.sync()
    if group is not None:
        group.barrier()
    setup_s = time.perf_counter() - t_start
    spans = Spans(profiled=False) if trace else _no_span
    e2e, attempted, _ = job.window(seconds=seconds, spans=spans)

    if trace:
        from torch.profiler import ProfilerActivity, profile
        units = job.job["trace_units"]
        cuda = dev.type == "cuda"
        # The device profile: kernels and copies alone.
        with profile(activities=[ProfilerActivity.CUDA] if cuda else
                     [ProfilerActivity.CPU]) as prof:
            traced, traced_units, traced_s = job.window(units=units,
                                                        spans=_no_span)
        dev_trace = (profile_reduce.device_trace(prof, traced_s) if cuda
                     else None)
        host_units = job.job["trace_units_host"]
        if lead:
            # The host profile, with the benchmark's spans, for the idle
            # gaps.
            marks = Spans(profiled=True)
            with profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else [])) as prof:
                with torch.profiler.record_function(profile_reduce.WINDOW):
                    job.window(units=host_units, spans=marks)
            host = profile_reduce.host_trace(prof, set(marks.durations))
            say(json.dumps({"tracing_overhead": {
                k: {"spans_only": e2e[k], "device_profile": traced[k],
                    "change_pct": 100.0 * (traced[k] - e2e[k]) / e2e[k]}
                for k in e2e}}))
        else:
            job.window(units=host_units, spans=_no_span)
        del prof

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    failed = job.failed()
    job.release()
    numbers, bounds = job.check()
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    busy = (dev_trace.busy_s, dev_trace.window_s) if (
        trace and dev_trace is not None and dev_trace.device) else None
    if group is None:
        facts = device_facts(dev, memory_peak)
        ranks = None
    else:
        ranks = group.gather({
            "device": group.identity(), "units": attempted,
            "checked": getattr(job, "kept", []), "failed": failed,
            "memory_peak_bytes": int(memory_peak), "busy": busy,
            "agree_ms": 1e3 * group.agree_s / max(group.agreed, 1),
            "forbidden": forbidden_modules()})
        if not lead:
            return None
        facts = ranks_facts(dev, ranks)
        failed = sum(r["failed"] for r in ranks)
        busy = (None if any(r["busy"] is None for r in ranks) else
                tuple(sum(x) / len(ranks) for x in zip(
                    *(r["busy"] for r in ranks))))
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and failed == 0

    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if trace:
        r = Reading(job.KIND, traced_units, dev_trace, spans.durations,
                    bounds)
        metrics = {}
        for entry, mod in per_layer_readers(name, base, root):
            value = mod.read(r)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
        out["metrics"] = metrics
        if busy is not None:
            facts["busy_s"], facts["window_s"] = busy
            out["breakdown"] = {"device_ops": dev_trace.top_device_ops(),
                                "idle_gaps": host.idle_gaps()}
    else:
        out["metrics"] = {k: {"value": v, "unit": job.UNITS[k]}
                          for k, v in e2e.items()}
        out["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    out["device"] = facts
    if ranks is not None:
        out["ranks"] = ranks
    out["checks"] = checks
    return out
