"""The benchmark of the PyTorch and CUDA port of the path tracer, one
cell and one seed a run, on the NVIDIA GPUs the cell asks for::

    python3 benchmark/run.py --workload cornell.train --seed 7 \
        --seconds 10 --trace 0

The last line of standard output is the result (see ``harness.py``); the
last lines of standard error are the numbers that decided ``correct``,
each beside its limit.  Without a CUDA device, or with fewer devices than
the cell asks for, it prints no result and exits with 2.

A cell of one card runs in this process.  A cell of n > 1 cards runs on n
ranks, one process a card, which this process starts (``ranks.py``) and
waits for: the ranks step and display the same frames, rank 0 decides
when the window ends and which frames are checked, and rank 0's line,
with every rank's device, comes back here.  It is printed once every rank
has ended cleanly; when a rank fails, holds a module the port must not
load, or the ranks ran on fewer distinct cards than the cell asks for, no
line is printed and the exit code is not 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
# Every build and kernel cache of the program stays inside the checkout,
# at fixed paths (the program builds its own library into its package's
# _build directory).
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "benchmark" / ".cache" / sub))


def main(argv=None):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    chips = harness.load("cells", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", file=sys.stderr)

    if chips > 1:
        from benchmark import ranks

        code, out = ranks.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), chips, T_START)
        if code:
            return code
    else:
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found}, which the port must "
              f"not load", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
