#!/usr/bin/env python3
"""Run one cell of the benchmark of ``olmoasr_tpu_torch`` on this machine's card.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the numbers that decided ``correct`` are also the
last lines of standard error, each beside its limit. Without a CUDA card,
or with fewer cards than the cell asks for, it prints no result and exits
with 2; if a module of JAX or of the JAX package was loaded, with 3.

``--control NAME[,NAME]`` (not part of a measured run) puts a control of
the traffic file's ``controls`` in the program's place and prints the
numbers it gives, to set the limits from.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
# build and kernel caches at fixed paths inside the checkout; no library the
# run uses may load JAX by itself
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default="")
    args = p.parse_args(argv)

    import torch

    from gpubench import core

    cell = core.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: {args.workload} needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        return 2
    # one process, one thread for the CPU's operations: a run's host time is
    # the timed path's own
    torch.set_num_threads(1)
    control = [c for c in args.control.split(",") if c]
    out = core.run(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                   control=control)
    bad = core.forbidden_modules()
    if bad:
        print(f"gpubench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
