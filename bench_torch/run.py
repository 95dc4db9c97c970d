#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on one CUDA card.

    python bench_torch/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Set-up builds or loads the kernels,
prepares the program's driver for the traffic's job (the initial state
from the seed, the P3M plan, a warm block or gradient) and warms what the
window runs.  With ``--trace 0`` it then drives the program's block loop,
or takes one rollout gradient after another, for ``--seconds`` and reports
the cell's end-to-end metrics; with ``--trace 1`` it profiles the cell's
stretch of whole segments instead and reports its per-layer metrics.
Either way it then frees the program, follows the segment (or takes the
gradient) with the plain reference in float64 and decides ``correct``.
The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of that object.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; with JAX or the JAX package loaded once
the window has closed, with code 3, naming them on standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)  # the program under test, nbody_tpu_torch

from harness import check, grad_check, spec  # noqa: E402


def environment(root: str) -> None:
    """Before torch is imported: every cache of a run inside the checkout,
    at fixed paths (the port builds its kernels into ``<root>/build/``
    itself; PyTorch's JIT kernel cache and the CUDA driver's go beside
    them).  Threads and cores are left as the program's own command line
    leaves them."""
    base = os.path.join(root, "build", "bench_torch")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(base, "torch")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")
    # PyTorch uses the kernel cache it is given only where it exists.
    os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


# Top-level modules the port must never load: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "nbody_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def checker(cell):
    """The check of the cell's job (``check.py``'s functions)."""
    return grad_check if cell.job == "rollout_grad" else check


class Context:
    """What the metric readers read."""

    def __init__(self, cell, setup_s, run, trace=None, stretch_states=()):
        self.cell = cell
        self.setup_s = setup_s
        self.run = run
        self.trace = trace
        self.stretch_states = stretch_states


def measure(cell, args, platform=None, overrides=None, t0=T0):
    """Set-up, then the window or the traced stretch.  Returns (program's
    outputs for the check, metrics, device record, breakdown).
    ``overrides``: program options that replace the configuration's (the
    control's)."""
    import torch

    from harness import program, trace, window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = program.make(cell.config, cell.traffic, args.seed,
                        platform=platform, overrides=overrides)
    cuda = prog.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
    prog.sync()
    setup_s = time.perf_counter() - t0
    keep = check.keep_blocks(cell.check)
    tr, states = None, ()
    if args.trace:
        with prog.spans(spec.spans(cell.per_layer)):
            # The ranged blocks are new closures: run one before the trace.
            prog.restore()
            prog.run_block()
            prog.sync()
            run, tr = trace.record(
                lambda: window.stretch(prog, cell.traffic, keep))
        states = prog.stretch_states()
        metrics = cell.per_layer
    else:
        run = window.timed(prog, cell.traffic, args.seconds, keep)
        metrics = cell.end_to_end
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": prog.device_name(),
              "count": 1,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                  prog.device) if cuda else 0)}
    ctx = Context(cell, setup_s, run, tr, states)
    values = {}
    for m in metrics:
        v = spec.reader(m.name)(ctx)
        if v is not None:
            values[m.name] = {"value": float(v), "unit": m.unit}
    breakdown = None
    if tr is not None:
        device["busy_s"] = tr.busy_us * 1e-6
        device["window_s"] = tr.window_us * 1e-6
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps":
                     tr.idle_by_host()}
    out = run.outputs
    produced = (out.kes, prog.host(out.first), prog.host(out.last),
                run.blocks)
    prog.close()
    del prog, out, run, ctx, states
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return produced, values, device, breakdown


def main(argv=None, platform=None) -> int:
    """``platform="cpu"`` skips the look for a card (the tests' hook)."""
    args = parse(argv)
    cell = spec.load(args.workload)
    environment(ROOT)
    import torch

    if platform is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"run.py: cell {cell.name} needs {cell.chips} CUDA "
                  "card(s); none usable here", file=sys.stderr)
            return 2
    return report(cell, args, platform)


def report(cell, args, platform=None) -> int:
    import torch

    produced, values, device, breakdown = measure(cell, args, platform)
    loaded = forbidden_modules()
    if loaded:
        print(f"run.py: loaded once the window closed: {loaded}",
              file=sys.stderr)
        return 3
    dev = torch.device("cpu") if platform == "cpu" else torch.device("cuda")
    kes, first, last, _ = produced
    job = checker(cell)
    limits = job.limits(cell.check)
    t = time.perf_counter()
    initial, ref = job.reference_run(cell.config, cell.traffic, cell.check,
                                     args.seed, dev)
    print(f"reference: {time.perf_counter() - t:.3f} s", file=sys.stderr)
    correct, shown = check.verdict(
        job.numbers(initial, ref, kes, first, last), limits)
    # Failed answers: the blocks off in what the host read (the energy, or
    # a gradient's loss); a state or gradient off counts one.
    failed = 0 if correct else max(1, job.failed_blocks(
        ref, kes, limits[job.HOST_READ]["limit"]))
    result = {"correct": bool(correct), "attempted": len(kes),
              "failed": int(failed), "metrics": values, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = shown
    for name, s in shown.items():
        print(f"compared {name} {s['value']!r} limit {s['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
