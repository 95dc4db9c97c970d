#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's and the
control's, seed by seed, in one process.

    python bench_torch/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 3]

For each seed it runs the cell as ``run.py`` does (set-up, a short window,
the reference) and prints the numbers the check compares (the lower
readings), then the control's (the upper readings): the configuration in
the precision below its own, as its ``control`` key says.  There,
``{"program": {...}}`` is a path of the program's own, switched on by those
options (the direct configurations' bf16 distance mode);
``{"reference": "bf16"}`` is the plain reference put in the program's
place, in float32 with its arrays rounded through bfloat16, where the
program has no such path (P3M refuses bf16).  One JSON line a seed, then
one with the largest program reading and the smallest control reading of
each number.  Needs a CUDA card, as run.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402
from harness import spec  # noqa: E402


def readings(cell, seed: int, seconds: float, platform=None) -> dict:
    """One seed's readings."""
    import torch

    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=0)
    dev = torch.device("cpu" if platform == "cpu" else "cuda")
    job = run.checker(cell)
    t = time.perf_counter()
    produced = run.measure(cell, args, platform, t0=t)[0]
    t_prog = time.perf_counter() - t
    t = time.perf_counter()
    initial, ref = job.reference_run(cell.config, cell.traffic, cell.check,
                                     seed, dev)
    t_ref = time.perf_counter() - t
    program = job.numbers(initial, ref, *produced[:3])
    t = time.perf_counter()
    how = cell.config["control"]
    if "program" in how:
        control = run.measure(cell, args, platform, overrides=how["program"],
                              t0=t)[0][:3]
    else:
        control = job.control_outputs(cell, seed, dev)
    t_ctl = time.perf_counter() - t
    return {"seed": seed, "program": program,
            "control": job.numbers(initial, ref, *control),
            "program_s": t_prog, "reference_s": t_ref, "control_s": t_ctl}


def main(argv=None, platform=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    a = p.parse_args(argv)
    cell = spec.load(a.workload)
    run.environment(run.ROOT)
    import torch

    if platform is None and not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        rows.append(readings(cell, seed, a.seconds, platform))
        print(json.dumps(rows[-1]), flush=True)
    summary = {name: {"lower": max(r["program"][name] for r in rows),
                      "upper": min(r["control"][name] for r in rows)}
               for name in run.checker(cell).NUMBERS}
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
