"""Readings that the limits of ``correct`` are set from, for one cell, on
many seeds in one process::

    python3 benchmark/calibrate.py --workload cornell.train \
        --seeds 11,12,13 --control-seeds 11,12 --seconds 2

For each seed: the cell's set-up, a window of ``--seconds``, and the
numbers of the program's run against the reference (the lower reading of
each limit is the largest of these over the seeds).  On the control seeds
also the numbers of the control, the reference in bfloat16 in the
program's place, and, for training and for a multi-card cell's frames, of
the faults planted in the reference in the program's place (the upper
reading).  One JSON line a seed; runs on the CPU as well, with ``--device
cpu`` and small sizes.  A cell of n > 1 cards runs its seeds on n ranks
(``ranks.py``), as ``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)


def run_seeds(group, workload, seeds, control, seconds, device, overrides,
              say=None, base=None):
    """One line a seed (see the module's docstring), each passed to
    ``say`` where given; returns the lines.  With ``group`` on every rank
    of a multi-card cell, and rank 0 alone says and returns them."""
    import torch

    from benchmark import harness

    lead = group is None or group.rank == 0
    lines = []
    for seed in seeds:
        t0 = time.perf_counter()
        _, job = harness.make_job(workload, seed, device,
                                  base=base or harness.HERE,
                                  overrides=overrides, group=group)
        job.setup()
        e2e, n, _ = job.window(seconds=seconds, spans=harness._no_span)
        job.release()
        t1 = time.perf_counter()
        numbers, bounds = job.check()
        t2 = time.perf_counter()
        line = {"seed": seed, "program": numbers, "e2e": e2e, "units": n,
                "bounds": bounds, "check_s": t2 - t1, "run_s": t1 - t0}
        if hasattr(job, "ref_readings"):
            from benchmark.compare import leaf_gaps, moving_leaves
            prog, ref = job.readings, job.ref_readings
            line["leaves"] = {
                "grads": leaf_gaps(prog["grads"], ref["grads"], ref["grads"]),
                "change": leaf_gaps(prog["change"], ref["change"],
                                    moving_leaves(ref["grads"]))}
        if seed in control:
            line.update(job.control_readings())
            line["control_s"] = time.perf_counter() - t2
        if lead:
            lines.append(line)
            if say is not None:
                say(json.dumps(line))
        del job
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return lines if lead else None


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--override", default="{}",
                   help="JSON object of traffic keys to replace")
    args = p.parse_args(argv)

    import functools

    from benchmark import harness, ranks

    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    overrides = json.loads(args.override)
    say = functools.partial(print, flush=True)
    chips = harness.load("cells", args.workload)["chips"]
    if chips == 1:
        run_seeds(None, args.workload, seeds, control, args.seconds,
                  args.device, overrides, say)
        return 0
    code, _ = ranks.launch(run_seeds, (
        args.workload, seeds, control, args.seconds, args.device, overrides,
        say), chips, args.device)
    return code


if __name__ == "__main__":
    sys.exit(main())
