#!/usr/bin/env python3
"""The P3M short-range kernel's launch shape, on one CUDA card.

    python scripts/sr_launch_shapes.py

``csrc/sr.cu`` fixes its launch shape at compile time: ``kGroups`` groups
of 64 threads per CTA take a run's entries in turn, and each CTA owns the
runs that start in its ``kChunk`` worklist entries.  This script rewrites
those two constants in a copy of the source for every shape of groups
(1, 2, 4) by chunk (4, 16, 64), builds each copy with the package's nvcc
flags into ``build/exp/sr_shapes/`` (one nvcc each, all started
together), and on the Plummer sphere of the JAX package's P3M gate
(N=262144, seed 7, ng=128, cutoff 4, each layout at its suggested plan)
prints the mean time of ten launches of each shape (CUDA events) in the
layouts ``pallas_paired`` (the card's default), ``pallas_paired_sym`` and
``pallas``, beside the package's kernel.  Each shape's output is held
against the package's kernel within 2e-5 of the largest occupied slot:
the shape changes only the summation order.  The first line is the card's
name and power limit.  Needs a CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (1, 2, 4)
CHUNKS = (4, 16, 64)
LAYOUTS = ("pallas_paired", "pallas_paired_sym", "pallas")


def build_shapes(out_dir: str) -> dict:
    """(groups, chunk) -> the loaded ctypes function ``nbt_sr_sweep`` of a
    copy of csrc/sr.cu built with that launch shape."""
    from nbody_tpu_torch.utils import build

    src = (build.CSRC_DIR / "sr.cu").read_text()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = {}
    for g in GROUPS:
        for c in CHUNKS:
            text, n_sub = re.subn(r"constexpr int kGroups = \d+;",
                                  f"constexpr int kGroups = {g};", src)
            text, m_sub = re.subn(r"constexpr int kChunk = \d+;",
                                  f"constexpr int kChunk = {c};", text)
            if (n_sub, m_sub) != (1, 1):
                raise RuntimeError("csrc/sr.cu no longer declares kGroups "
                                   "and kChunk once each")
            cu = os.path.join(out_dir, f"sr_g{g}_c{c}.cu")
            with open(cu, "w") as f:
                f.write(text)
            so = cu[:-3] + ".so"
            cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I",
                   str(build.CSRC_DIR), "-o", so, cu]
            jobs[(g, c)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    fns = {}
    for shape, (so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for shape {shape}:\n{out}")
        fn = ctypes.CDLL(so).nbt_sr_sweep
        fn.argtypes = list(build.SIGNATURES["nbt_sr_sweep"])
        fn.restype = ctypes.c_int
        fns[shape] = fn
    return fns


def launch(fn, pk, bounds, sym: bool, paired: bool):
    """One launch of a shape's kernel, as ops/sr_kernel.sweep makes it."""
    import torch

    from nbody_tpu_torch.ops import pm

    nslots = pk["ptab"].shape[1]
    fwd = torch.zeros((3, nslots), dtype=torch.float32, device="cuda")
    react = torch.zeros_like(fwd) if sym else fwd
    err = fn(pk["ptab"].data_ptr(), pk["mtab"].data_ptr(), nslots,
             pk["wl_t"].data_ptr(), pk["wl_s"].data_ptr(),
             pk["wl_t"].shape[0], bounds.data_ptr(), pk["rc2"].data_ptr(),
             fwd.data_ptr(), react.data_ptr(), int(sym), int(paired),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"nbt_sr_sweep: CUDA error {err} at launch")
    out = fwd + react if sym else fwd
    out[:, nslots - pm.SLAB:] = 0.0
    return out


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.ops import pm, sr_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    fns = build_shapes(os.path.join(ROOT, "build", "exp", "sr_shapes"))
    pos, _, mass = distributions.plummer(262144, seed=7)
    p = torch.tensor(pos, device="cuda")
    m = torch.tensor(mass, device="cuda")
    for layout in LAYOUTS:
        sym, paired = pm.SR_LAYOUTS[layout]
        plan = pm.suggest_sr_plan(p, m, 128, 4, layout=layout)
        pk = pm.sr_pack_inputs(p, m, grid=128, cutoff_cells=4, symmetric=sym,
                               paired=paired, **plan)
        bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
        tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
                pk["rc2"])
        ref = sr_kernel.sweep(*tabs, symmetric=sym, paired=paired)
        occ = pk["mtab"] > 0
        scale = float(ref[:, occ].abs().max())
        ms_pkg = cuda_ms(lambda: sr_kernel.sweep(*tabs, symmetric=sym,
                                                 paired=paired))
        times = []
        for (g, c), fn in fns.items():
            got = launch(fn, pk, bounds, sym, paired)
            diff = float((got - ref)[:, occ].abs().max())
            if diff > 2e-5 * scale:
                print(f"FAIL: {layout} groups {g} chunk {c} disagrees with "
                      f"the package's kernel ({diff / scale:.3e})",
                      file=sys.stderr)
                return 1
            t = cuda_ms(lambda fn=fn: launch(fn, pk, bounds, sym, paired))
            times.append(f"groups {g} chunk {c} {t:.4f}")
        print(f"sr {layout}, {int(pk['n_e'])} entries: the package's kernel "
              f"{ms_pkg:.4f} ms; " + ", ".join(times) + f" (ms) [{card}]",
              flush=True)
        del pk, tabs, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
