#!/usr/bin/env python3
"""The P3M short-range kernel's and its VJP's launch shapes and work counts.

    python scripts/sr_launch_shapes.py            # launch shapes, one card
    python scripts/sr_launch_shapes.py --tree DIR  # another checkout's kernels
    python scripts/sr_launch_shapes.py --stats [--device cpu] [--sample 2000]
        [--capacity 16384]

All three take the Plummer sphere of the JAX package's P3M gate (N=262144,
seed 7, ng=128, cutoff 4), each layout at its suggested plan; the VJP
takes the two unpaired layouts, ``pallas`` and ``pallas_sym``, with a
seeded cotangent, at the gate and, on the card, on the ghost-extended
tables of ``bench.py:48-49``'s periodic row (the reference initial
conditions at N=1048576 boxed at L = 1, ng=128, cutoff 4), with the peak
memory of one call beyond what was allocated before it.

``csrc/sr.cu`` and ``csrc/sr_vjp.cu`` fix their launch shapes at compile
time: ``kGroups`` groups of 64 threads a CTA, each taking one unit of
``kUnit`` worklist entries (positions, in the VJP's passes).  With no
option this script rewrites those two constants in a copy of each source
for every shape of groups (1, 2, 3) by unit (8, 16, 32), builds each copy
with the package's nvcc flags into ``build/exp/sr_shapes/`` (one nvcc
each, all started together), and prints the mean time of ten launches of
each shape (CUDA events) in every layout beside the package's kernel.
The sweep of each shape is held against the package's kernel within 2e-5
of the largest occupied slot (the shape changes only the summation order),
and the VJP of each shape, and of the package (also with ``--tree``),
against the plain VJP (``sweep_vjp_plain``): gp and gm within 1e-5 of the
largest, the error printed beside the time.  ``--tree DIR``
instead times only the package kernels of another checkout
(``nbody_tpu_torch`` imported from DIR, its kernels built into DIR's
``build/``), through the public wrappers ``sweep`` and ``sweep_vjp``, whose
signatures every version keeps, so two commits compare in one call on one
card; it also prints a digest of each sweep's output in the layouts that
repeat bit for bit (no reaction atomics), so two trees' outputs compare bit
for bit.  The first line is the card's name and power limit.  Needs a CUDA
card and nvcc.

``--stats`` runs on any device (the CPU by default) and prints, for each
layout, the work of the sweep: worklist entries and pairs an entry, the
pairs evaluated, the runs (entries of one target slab; count, longest and
mean), the share of evaluated pairs inside the cutoff, and the share of
(warp of 32 targets, source) steps wholly beyond it, under three
schedules: the slab's slots in order with every lane on one source, the
kernel's split of each slab into two compact warps
(``ops/sr_kernel.split_order``) with every lane on one source, and the
kernel's own schedule (``ops/sr_kernel.skip_counts``: the reaction's
rotation where a step takes both sides).  It also prints the share of
those steps the kernel's schedule keeps (runs) on the tables as packed,
each cell's particles in sub-cell key order, and on the same pack with
each cell back in input order (the same pack under a zero key, as the
JAX package packs): what the order buys.  ``--capacity`` sets the
cell capacity (0: each layout's suggested plan; the benchmark's P3M cells
run 16384).  For ``pallas`` and
``pallas_sym`` it also prints the VJP kernel's work
(``ops/sr_kernel.vjp_skip_counts``): its (warp, other) steps a pass and the
share of them that the target pass and the source pass each skip.  The
shares come from ``--sample`` entries drawn with a fixed seed (0: every
entry).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (1, 2, 3)
UNITS = (8, 16, 32)
LAYOUTS = ("pallas_paired", "pallas", "pallas_sym", "pallas_paired_sym")
VJP_LAYOUTS = ("pallas", "pallas_sym")  # the unpaired ones, which AD runs
GATE = dict(n=262144, seed=7, grid=128, cutoff=4)  # bench.py:102-103
PERIODIC = dict(n=1048576, box=1.0)  # bench.py:48-49, at the gate's grid


def gate_inputs(device: str, capacity: int = 0):
    """(pm, sr_kernel, {layout: (packed inputs, bounds, sym, paired)}), at
    the plan suggested for ``capacity`` (0: the suggested capacity)."""
    import torch

    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.ops import pm, sr_kernel

    pos, _, mass = distributions.plummer(GATE["n"], seed=GATE["seed"])
    p = torch.tensor(pos, device=device)
    m = torch.tensor(mass, device=device)
    out = {}
    for layout in LAYOUTS:
        sym, paired = pm.SR_LAYOUTS[layout]
        # On the CPU the plan is sized for the unpaired worklist, which is
        # longer than the paired one: nothing drops.
        plan = pm.suggest_sr_plan(p, m, GATE["grid"], GATE["cutoff"],
                                  capacity=capacity, layout=layout)
        pk = pm.sr_pack_inputs(p, m, grid=GATE["grid"],
                               cutoff_cells=GATE["cutoff"], symmetric=sym,
                               paired=paired, **plan)
        if int(pk["n_e"]) > pk["e_max"]:
            raise RuntimeError(f"{layout}: the suggested plan drops entries")
        bounds = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
        out[layout] = (pk, bounds, sym, paired)
    return pm, sr_kernel, out


def periodic_inputs() -> dict:
    """{layout: (tables, bounds, sym)} of the periodic row on the card, for
    the VJP's layouts, each at its suggested differentiable plan."""
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import pm

    ref = make_state(PERIODIC["n"], device="cuda")
    bkw = dict(boundary="periodic", box_size=PERIODIC["box"])
    out = {}
    for layout in VJP_LAYOUTS:
        sym = pm.SR_LAYOUTS[layout][0]
        plan = pm.suggest_sr_plan(ref.pos, ref.mass, GATE["grid"],
                                  GATE["cutoff"], layout=layout,
                                  differentiable=True, **bkw)
        tabs = pm.sr_pack_inputs(ref.pos, ref.mass, GATE["grid"],
                                 GATE["cutoff"], symmetric=sym, **plan,
                                 **bkw)
        if int(tabs["n_e"]) > tabs["e_max"]:
            raise RuntimeError(f"periodic {layout}: the plan drops entries")
        bounds = torch.stack([torch.zeros_like(tabs["n_e"]), tabs["n_e"]])
        out[layout] = (tabs, bounds, sym)
    return out


def peak_mb(fn) -> float:
    """MB that one call of ``fn`` allocates beyond what was held before."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - held) / 2**20


def build_shapes(out_dir: str) -> dict:
    """(source, groups, unit) -> the loaded ctypes library of a copy of
    csrc/<source>.cu built with that launch shape, for source sr and
    sr_vjp."""
    from nbody_tpu_torch.utils import build

    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.find_nvcc()
    jobs = {}
    for name in ("sr", "sr_vjp"):
        src = (build.CSRC_DIR / f"{name}.cu").read_text()
        for g in GROUPS:
            for u in UNITS:
                text, n_sub = re.subn(r"constexpr int kGroups = \d+;",
                                      f"constexpr int kGroups = {g};", src)
                text, m_sub = re.subn(r"constexpr int kUnit = \d+;",
                                      f"constexpr int kUnit = {u};", text)
                if (n_sub, m_sub) != (1, 1):
                    raise RuntimeError(f"csrc/{name}.cu no longer declares "
                                       "kGroups and kUnit once each")
                cu = os.path.join(out_dir, f"{name}_g{g}_u{u}.cu")
                with open(cu, "w") as f:
                    f.write(text)
                so = cu[:-3] + ".so"
                cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-I",
                       str(build.CSRC_DIR), "-o", so, cu]
                jobs[(name, g, u)] = (so, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
    libs = {}
    for shape, (so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for shape {shape}:\n{out}")
        if shape[0] == "sr_vjp":  # the registers and spills of each shape
            print(f"{shape}: " + "; ".join(
                line.strip() for line in out.splitlines()
                if "registers" in line or "spill" in line), flush=True)
        lib = ctypes.CDLL(so)
        for fn in (("nbt_sr_sweep", "nbt_sr_unit") if shape[0] == "sr"
                   else ("nbt_sr_vjp", "nbt_sr_vjp_unit")):
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[shape] = lib
    return libs


def launch(lib, pk, bounds, sym: bool, paired: bool):
    """One sweep of a shape's kernels, as ops/sr_kernel.sweep makes it."""
    import torch

    from nbody_tpu_torch.ops import pm, sr_kernel

    nslots, e_max = pk["ptab"].shape[1], pk["wl_t"].shape[0]
    fwd = torch.zeros((3, nslots), dtype=torch.float32, device="cuda")
    react = torch.zeros_like(fwd) if sym else fwd
    scratch = torch.empty(
        sr_kernel.scratch_floats(nslots, e_max, lib.nbt_sr_unit()),
        dtype=torch.float32, device="cuda")
    err = lib.nbt_sr_sweep(
        pk["ptab"].data_ptr(), pk["mtab"].data_ptr(), nslots,
        pk["wl_t"].data_ptr(), pk["wl_s"].data_ptr(), e_max,
        bounds.data_ptr(), pk["rc2"].data_ptr(), fwd.data_ptr(),
        react.data_ptr(), scratch.data_ptr(), int(sym), int(paired),
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


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def shapes(tree_only: bool) -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    name = card()
    print(name, flush=True)
    libs = {} if tree_only else build_shapes(
        os.path.join(ROOT, "build", "exp", "sr_shapes"))
    _, sr_kernel, inputs = gate_inputs("cuda")
    for layout, (pk, bounds, sym, paired) in inputs.items():
        tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
                pk["rc2"])
        ref = sr_kernel.sweep(*tabs, symmetric=sym, paired=paired)
        occ = pk["mtab"] > 0
        scale = float(ref[:, occ].abs().max())
        ms_pkg = cuda_ms(lambda: sr_kernel.sweep(*tabs, symmetric=sym,
                                                 paired=paired))
        times = []
        for (src, g, u), lib in libs.items():
            if src != "sr":
                continue
            got = launch(lib, pk, bounds, sym, paired)
            diff = float((got - ref)[:, occ].abs().max())
            if diff > 2e-5 * scale:
                print(f"FAIL: {layout} groups {g} unit {u} disagrees with "
                      f"the package's kernel ({diff / scale:.3e})",
                      file=sys.stderr)
                return 1
            t = cuda_ms(lambda lib=lib: launch(lib, pk, bounds, sym, paired))
            times.append(f"groups {g} unit {u} {t:.4f}")
        bits = "" if sym else f" (output sha256 {digest(ref)})"
        print(f"sr {layout}, {int(pk['n_e'])} entries: the package's kernel "
              f"{ms_pkg:.4f} ms{bits}" + "".join(f"; {t}" for t in times) +
              f" (ms) [{name}]", flush=True)
        del ref
        if layout not in VJP_LAYOUTS:
            continue
        gen = torch.Generator("cuda").manual_seed(11)
        args = (*tabs, torch.randn(pk["ptab"].shape, device="cuda",
                                   generator=gen))
        plain = sr_kernel.sweep_vjp_plain(*args, symmetric=sym)

        def err(got):  # of gp and gm, a share of the plain one's largest
            return max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(got[:2], plain[:2]))

        e_pkg = err(sr_kernel.sweep_vjp(*args, symmetric=sym))
        mb = peak_mb(lambda: sr_kernel.sweep_vjp(*args, symmetric=sym))
        ms_pkg = cuda_ms(lambda: sr_kernel.sweep_vjp(*args, symmetric=sym))
        times = []
        for (src, g, u), lib in libs.items():
            if src != "sr_vjp":
                continue
            diff = err(sr_kernel.launch_vjp(lib, *args, symmetric=sym))
            if diff > 1e-5:
                print(f"FAIL: vjp {layout} groups {g} unit {u} disagrees "
                      f"with the plain VJP ({diff:.3e})", file=sys.stderr)
                return 1
            t = cuda_ms(lambda lib=lib: sr_kernel.launch_vjp(
                lib, *args, symmetric=sym))
            times.append(f"groups {g} unit {u} {t:.4f} ({diff:.2e})")
        print(f"sr vjp {layout}, {int(pk['n_e'])} entries: the package's "
              f"kernel {ms_pkg:.4f} ms ({e_pkg:.2e}), peak {mb:.1f} MB" +
              "".join(f"; {t}" for t in times) + f" (ms, and gp and gm "
              f"against the plain VJP, of its largest) [{name}]", flush=True)
        del args, plain
    del inputs
    for layout, (tabs, bounds, sym) in periodic_inputs().items():
        gen = torch.Generator("cuda").manual_seed(11)
        args = (tabs["ptab"], tabs["mtab"], tabs["wl_t"], tabs["wl_s"], bounds,
                tabs["rc2"], torch.randn(tabs["ptab"].shape, device="cuda",
                                         generator=gen))
        mb = peak_mb(lambda: sr_kernel.sweep_vjp(*args, symmetric=sym))
        ms_pkg = cuda_ms(lambda: sr_kernel.sweep_vjp(*args, symmetric=sym))
        print(f"sr vjp periodic {layout}, {int(tabs['n_e'])} entries: the "
              f"package's kernel {ms_pkg:.4f} ms, peak {mb:.1f} MB [{name}]",
              flush=True)
        del args
    return 0


def stats(device: str, sample: int, capacity: int = 0) -> int:
    import numpy as np
    import torch

    pm, sr_kernel, inputs = gate_inputs(device, capacity)
    # The same pack with each cell in input order: a zero sub-cell key.
    with mock.patch.object(pm, "_subcell_key", lambda p, *_: torch.zeros(
            p.shape[1], dtype=torch.int32, device=p.device)):
        unordered = gate_inputs(device, capacity)[2]
    print(f"P3M gate: Plummer N={GATE['n']}, seed {GATE['seed']}, ng "
          f"{GATE['grid']}, cutoff {GATE['cutoff']}, capacity "
          f"{capacity or 'as suggested'}; shares over {sample or 'all'} "
          f"entries a layout, on {device}", flush=True)
    for layout, (pk, bounds, sym, paired) in inputs.items():
        n_e = int(pk["n_e"])
        width = 2 * pm.SLAB if paired else pm.SLAB
        wl_t = pk["wl_t"][:n_e]
        starts = torch.ones_like(wl_t, dtype=torch.bool)
        starts[1:] = wl_t[1:] != wl_t[:-1]
        lens = torch.diff(torch.cat([starts.nonzero()[:, 0],
                                     torch.tensor([n_e], device=device)]))
        pick = torch.arange(n_e, device=device)
        if sample and sample < n_e:
            rng = np.random.default_rng(0)
            pick = torch.tensor(np.sort(rng.choice(n_e, sample, replace=False)),
                                device=device)
        args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
                pk["rc2"])
        # The forward schedule with the split, and with the slots in order.
        split = sr_kernel.skip_counts(*args, paired=paired, entries=pick)
        plain = _ordered_counts(sr_kernel, pk, paired, pick)
        kernel = sr_kernel.skip_counts(*args, symmetric=sym, paired=paired,
                                       entries=pick)
        base_pk = unordered[layout][0]
        if not torch.equal(base_pk["wl_s"], pk["wl_s"]):
            raise RuntimeError(f"{layout}: the order changed the worklist")
        base = sr_kernel.skip_counts(base_pk["ptab"], base_pk["mtab"],
                                     *args[2:], symmetric=sym, paired=paired,
                                     entries=pick)
        print(f"{layout}: {n_e} entries x {pm.SLAB * width} pairs = "
              f"{n_e * pm.SLAB * width:.4g} pairs evaluated; runs "
              f"{int(lens.numel())}, longest {int(lens.max())}, mean "
              f"{float(lens.float().mean()):.1f} entries; inside the cutoff "
              f"{kernel['inside'] / kernel['pairs']:.4f} of the evaluated "
              f"pairs; (warp, source) steps wholly beyond: slots in order "
              f"{plain:.4f}, split {split['skipped'] / split['steps']:.4f}, "
              f"the kernel's schedule "
              f"{kernel['skipped'] / kernel['steps']:.4f}", flush=True)
        print(f"{layout}: (warp, source) steps the kernel keeps: as packed "
              f"(sub-cell order) {1 - kernel['skipped'] / kernel['steps']:.4f}"
              f", each cell in input order "
              f"{1 - base['skipped'] / base['steps']:.4f}", flush=True)
        if layout in VJP_LAYOUTS:
            vjp = sr_kernel.vjp_skip_counts(*args, entries=pick)
            print(f"{layout} vjp: (warp, other) steps a pass "
                  f"{vjp['steps']} over the sampled entries "
                  f"({vjp['steps'] / pick.shape[0] * n_e:.4g} in all); "
                  f"skipped: target pass {vjp['target'] / vjp['steps']:.4f}, "
                  f"source pass {vjp['source'] / vjp['steps']:.4f}",
                  flush=True)
    return 0


def _ordered_counts(sr_kernel, pk, paired: bool, pick) -> float:
    """The share of (warp, source) steps wholly beyond the cutoff with each
    slab's slots in order: lanes 0-31 and 32-63 as packed."""
    from nbody_tpu_torch.ops import pm

    width = 2 * pm.SLAB if paired else pm.SLAB
    tab = sr_kernel.packed_table(pk["ptab"], pk["mtab"])
    beyond = steps = 0
    for c0 in range(0, pick.shape[0], 256):
        idx = pick[c0:c0 + 256]
        te, se = pk["wl_t"][idx].long(), pk["wl_s"][idx].long()
        d = (tab.view(-1, width, 4)[se][:, None, :, :3]
             - tab.view(-1, pm.SLAB, 4)[te][:, :, None, :3])
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        out = (r2 * (1.0 / pk["rc2"]) >= 1.0).view(-1, 2, 32, width)
        beyond += int(out.all(dim=2).sum())
        steps += out.shape[0] * 2 * width
    return beyond / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="time the package kernel of this checkout only")
    ap.add_argument("--stats", action="store_true",
                    help="print the sweep's work counts (any device)")
    ap.add_argument("--device", default="cpu", help="--stats: the device")
    ap.add_argument("--sample", type=int, default=2000,
                    help="--stats: entries a layout (0: every entry)")
    ap.add_argument("--capacity", type=int, default=0,
                    help="--stats: the cell capacity (0: as suggested)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    if args.stats:
        return stats(args.device, args.sample, args.capacity)
    return shapes(tree_only=args.tree is not None)


if __name__ == "__main__":
    sys.exit(main())
