#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. The card: CUDA must be available; prints ``nvidia-smi``'s name and
   power limit.
2. The build: compiles ``nbody_tpu_torch/csrc/*.cu`` with nvcc (sm_90a)
   and prints the seconds it took and the compiler's register report.
3. Kernels against their plain PyTorch versions on the card, at N=2048,
   N=16384 and N=2000 padded to 2048: relative-norm error <= 1e-5, padded
   particles get exactly 0 from the pair-symmetric kernel, and padded
   sources add exactly nothing in the tiled kernel.
4. The main path: ``run(SimConfig(n=2000, nsteps=500))`` with ``auto``
   (must launch the pair-symmetric kernel and not the tiled one) and with
   ``kernel="pallas"`` (the tiled kernel); both kinetic-energy traces must
   equal tests/golden/ver0_n2000_s500.txt at %.5g in all 10 rows.  The
   launch counters are zeroed just before and read just after each run.
5. The numbers: N=16384 for 500 steps with ``auto`` (GFLOP/s under the
   reference's 29N^2+19N model, mean +- dev over blocks 3..10) and the
   per-sweep time of both kernels, their plain versions and ``naive`` at
   N=16384, timed with CUDA events.
6. The fused blocks against their plain versions, at N=2048 and N=2000
   padded to 2048: both layouts, Euler and leapfrog, one 50-step block;
   relative-norm error of pos and vel <= 1e-5, padded particles keep
   exactly zero velocity in the rows layout (below 1e-9 in the columns
   layout, whose one-sided sweep pulls a zero-mass target as JAX's does),
   and two launches on one input agree bit for bit.
   Prints whether an Euler block of each layout equals the unfused block
   over Kernel B (rows) or A (columns) bit for bit.
7. The fused main path: ``run(SimConfig(n=2000, nsteps=500, fused=True))``
   (rows) and with ``tile_i=64, tile_j=256`` (columns); both traces must
   equal the golden trace, and each run must launch the fused kernel 11
   times (10 blocks and the warm-up) and the unfused kernels never.  One
   leapfrog run must give finite, positive energies.
8. The fused numbers: N=2000 and N=16384 for 500 steps with ``fused=True``
   beside the unfused ``auto`` figures above; the N=16384 run must launch
   the rows kernel 11 times and the unfused kernels never.  At N=16384,
   where the rows kernel's CTAs each take many of the 8256 tile pairs,
   one 50-step Euler block of each layout is held against its plain
   version (relative-norm error <= 1e-5) and must repeat bit for bit;
   then the per-block time of each fused kernel and of its plain version
   (CUDA events).

The last two lines are a JSON object of the kernels and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "ver0_n2000_s500.txt")
REL_TOL = 1e-5  # fp32, different summation order: relative-norm error bound
TIME_REPS = 20
BLOCK = 50  # steps of a sample block
# The fused layouts: (label, tile_i, tile_j); rows take the default block.
FUSED = (("rows", 0, 0), ("columns", 64, 256))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> float:
    return float((got - ref).norm() / ref.norm())


def time_ms(fn, reps: int = TIME_REPS) -> float:
    """Mean device milliseconds per call, from CUDA events around ``reps``
    calls after one warm-up call."""
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
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.models.gravity import make_accel_fn, make_block_fn
    from nbody_tpu_torch.ops import fused_block, naive, sym_kernel, tiled_kernel
    from nbody_tpu_torch.utils import build
    from nbody_tpu_torch.utils.reporting import _g5, parse_trace

    # 1. The card.
    card = card_line()
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. The build.
    path, secs = build.build(verbose=True)
    build.library()
    print(f"build: {secs:.2f} s -> {os.path.relpath(path, ROOT)}", flush=True)

    # 3. Kernels against their plain versions.
    err = {"A": 0.0, "B": 0.0}
    for n, n_pad in ((2048, 2048), (16384, 16384), (2000, 2048)):
        st = make_state(n, pad_multiple=n_pad, device=dev)
        pos, mass = st.pos, st.mass
        a = tiled_kernel.accelerations(pos, mass)
        a_plain = tiled_kernel.accelerations_between_plain(pos, pos, mass)
        b = sym_kernel.accelerations(pos, mass)
        b_plain = sym_kernel.accelerations_plain(pos, mass)
        ref = naive.accelerations(pos, mass)
        torch.cuda.synchronize()
        ra, rb = rel_err(a, a_plain), rel_err(b, b_plain)
        err["A"] = max(err["A"], float((a - a_plain).abs().max()))
        err["B"] = max(err["B"], float((b - b_plain).abs().max()))
        print(f"kernels N={n} (padded {n_pad}): tiled vs plain {ra:.3e}, "
              f"sym vs plain {rb:.3e}; vs naive: tiled "
              f"{rel_err(a, ref):.3e}, sym {rel_err(b, ref):.3e}", flush=True)
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"non-finite accelerations at N={n}")
        if ra > REL_TOL or rb > REL_TOL:
            fail(f"kernel disagrees with its plain version at N={n}")
        if n_pad > n:
            if bool((b[:, n:] != 0).any()):
                fail("sym kernel: padded particles got non-zero acceleration")
            # Kernel A masks ragged sources itself: the unpadded sweep must
            # give the real targets exactly what the padded one gives.
            real = [t.contiguous() for t in (pos[:, :n], mass[:n])]
            a_real = tiled_kernel.accelerations(*real)
            if not torch.equal(a_real, a[:, :n]):
                fail("tiled kernel: padded sources changed the result")
            print(f"padding N={n}->{n_pad}: sym padded columns exactly 0, "
                  "tiled unpadded == padded exactly", flush=True)

    # 4. The main path through both kernels.
    with open(GOLDEN) as f:
        golden = parse_trace(f.read())
    launches = {}
    gf = {}  # "N config" -> (GFLOP/s mean, dev)
    for label, kernel, mod, other in (
        ("B", "auto", sym_kernel, tiled_kernel),
        ("A", "pallas", tiled_kernel, sym_kernel),
    ):
        tiled_kernel.launches = 0
        sym_kernel.launches = 0
        res = run(SimConfig(n=2000, nsteps=500, kernel=kernel), out=sys.stdout)
        launches[label] = mod.launches
        print(f"main path kernel={kernel}: {mod.__name__} launches "
              f"{mod.launches}, {other.__name__} launches {other.launches}; "
              f"{res.av:.5g} +- {res.dev:.5g} GFLOP/s {tag}", flush=True)
        if mod.launches < 500 or other.launches != 0:
            fail(f"kernel={kernel} did not run through {mod.__name__} alone")
        got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
        if got != golden:
            fail(f"kernel={kernel} trace {got} != golden {golden}")
        print(f"main path kernel={kernel}: all {len(golden)} kinetic-energy "
              "rows equal ver0_n2000_s500.txt at %.5g", flush=True)
        gf[f"2000 {kernel}"] = (res.av, res.dev)

    # 5. The numbers.
    res = run(SimConfig(n=16384, nsteps=500), quiet=True)
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"N=16384 kinetic energies not finite and positive: {kes}")
    n = 16384
    print(f"N={n} 500 steps auto: {res.av:.6g} +- {res.dev:.6g} GFLOP/s "
          f"(29N^2+19N model), total {res.total_time:.4f} s {tag}", flush=True)
    gf[f"{n} auto"] = (res.av, res.dev)
    st = make_state(n, device=dev)
    pos, mass = st.pos, st.mass
    ms = {
        "naive": time_ms(lambda: naive.accelerations(pos, mass)),
        "A_plain": time_ms(lambda: tiled_kernel.accelerations_between_plain(
            pos, pos, mass)),
        "A": time_ms(lambda: tiled_kernel.accelerations(pos, mass)),
        "B": time_ms(lambda: sym_kernel.accelerations(pos, mass)),
        "B_plain": time_ms(lambda: sym_kernel.accelerations_plain(pos, mass)),
    }
    ms["A_again"] = time_ms(lambda: tiled_kernel.accelerations(pos, mass))
    for name, t in ms.items():
        print(f"sweep N={n} {name}: {t:.4f} ms, {n * n / t / 1e6:.1f} "
              f"Gpairs/s (N^2 model) {tag}", flush=True)

    # 6. The fused blocks against their plain versions.
    for label, _, _ in FUSED:
        err[label] = 0.0
    for n, n_pad in ((2048, 2048), (2000, 2048)):
        st = make_state(n, pad_multiple=n_pad, device=dev)
        for label, ti, tj in FUSED:
            for integrator in ("euler", "leapfrog"):
                args = (st.pos, st.vel, st.mass, 0.1, BLOCK, ti, tj, integrator)
                p, v = fused_block.fused_block(*args)
                p2, v2 = fused_block.fused_block(*args)
                p_ref, v_ref = fused_block.fused_block_plain(*args)
                torch.cuda.synchronize()
                rp, rv = rel_err(p, p_ref), rel_err(v, v_ref)
                err[label] = max(err[label], float((p - p_ref).abs().max()),
                                 float((v - v_ref).abs().max()))
                print(f"fused {label} {integrator} N={n} (padded {n_pad}), "
                      f"{BLOCK} steps: pos vs plain {rp:.3e}, vel vs plain "
                      f"{rv:.3e}", flush=True)
                if not (torch.isfinite(p).all() and torch.isfinite(v).all()):
                    fail(f"fused {label} {integrator}: non-finite state")
                if rp > REL_TOL or rv > REL_TOL:
                    fail(f"fused {label} {integrator} disagrees with its "
                         f"plain version at N={n}")
                if not (torch.equal(p, p2) and torch.equal(v, v2)):
                    fail(f"fused {label} {integrator}: two launches on one "
                         "input differ")
                # Padding: the rows layout divides by the mass, so padded
                # particles get exactly 0; the columns layout, as JAX's
                # _kernel and Kernel A, gives a zero-mass target the real
                # particles' pull, about 1e-16 from its place 1e6 away.
                v_pad = float(v[:, n:].abs().max()) if n_pad > n else 0.0
                if v_pad != 0 and (label == "rows" or v_pad > 1e-9):
                    fail(f"fused {label} {integrator}: padded particles "
                         f"moved, |v| up to {v_pad:.3e}")
        for label, ti, tj, kernel in (("rows", 0, 0, "pallas_sym"),
                                      ("columns", 64, 256, "pallas")):
            p, v = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1,
                                           BLOCK, ti, tj)
            blk = make_block_fn(make_accel_fn(kernel, tile_i=ti or 128,
                                              tile_j=tj), 0.1, BLOCK)
            want, _ = blk(st)
            same = torch.equal(p, want.pos) and torch.equal(v, want.vel)
            print(f"fused {label} euler N={n}: bit for bit equal to the "
                  f"unfused {kernel} block: {same}; max abs diff pos "
                  f"{float((p - want.pos).abs().max()):.3e}", flush=True)
        print(f"fused N={n}: both layouts repeat bit for bit; padded "
              "velocities exactly 0 in the rows layout", flush=True)

    # 7. The fused main path, through each layout.
    for label, ti, tj in FUSED:
        fused_block.launches = tiled_kernel.launches = sym_kernel.launches = 0
        res = run(SimConfig(n=2000, nsteps=500, fused=True, tile_i=ti,
                            tile_j=tj), out=sys.stdout)
        launches[label] = fused_block.launches
        print(f"fused main path {label}: fused_block launches "
              f"{fused_block.launches}, sym {sym_kernel.launches}, tiled "
              f"{tiled_kernel.launches}; {res.av:.6g} +- {res.dev:.6g} "
              f"GFLOP/s {tag}", flush=True)
        if (fused_block.launches, sym_kernel.launches,
                tiled_kernel.launches) != (11, 0, 0):
            fail(f"fused {label} run did not go through the fused kernel "
                 "alone, once a block")
        got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
        if got != golden:
            fail(f"fused {label} trace {got} != golden {golden}")
        print(f"fused main path {label}: all {len(golden)} kinetic-energy "
              "rows equal ver0_n2000_s500.txt at %.5g", flush=True)
        gf[f"2000 fused {label}"] = (res.av, res.dev)
    res = run(SimConfig(n=2000, nsteps=500, fused=True,
                        integrator="leapfrog"), quiet=True)
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"fused leapfrog energies not finite and positive: {kes}")
    print(f"fused leapfrog N=2000/500: energies finite and positive, "
          f"{kes[0]:.5g} .. {kes[-1]:.5g}", flush=True)

    # 8. The fused numbers.
    n = 16384
    fused_block.launches = tiled_kernel.launches = sym_kernel.launches = 0
    res = run(SimConfig(n=n, nsteps=500, fused=True), quiet=True)
    counts = (fused_block.launches, sym_kernel.launches, tiled_kernel.launches)
    print(f"fused N={n} rows: fused_block launches {counts[0]}, sym "
          f"{counts[1]}, tiled {counts[2]}", flush=True)
    if counts != (11, 0, 0):
        fail(f"fused N={n} run did not go through the fused kernel alone, "
             "once a block")
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"N={n} fused kinetic energies not finite and positive: {kes}")
    gf[f"{n} fused rows"] = (res.av, res.dev)
    for key in ("2000 auto", "2000 fused rows", "2000 fused columns",
                f"{n} auto", f"{n} fused rows"):
        av, sd = gf[key]
        print(f"N={key}, 500 steps: {av:.6g} +- {sd:.6g} GFLOP/s "
              f"(29N^2+19N model) {tag}", flush=True)
    st = make_state(n, device=dev)
    for label, ti, tj in FUSED:
        args = (st.pos, st.vel, st.mass, 0.1, BLOCK, ti, tj)
        p, v = fused_block.fused_block(*args)
        p2, v2 = fused_block.fused_block(*args)
        p_ref, v_ref = fused_block.fused_block_plain(*args)
        torch.cuda.synchronize()
        rp, rv = rel_err(p, p_ref), rel_err(v, v_ref)
        err[label] = max(err[label], float((p - p_ref).abs().max()),
                         float((v - v_ref).abs().max()))
        print(f"fused {label} euler N={n}, {BLOCK} steps: pos vs plain "
              f"{rp:.3e}, vel vs plain {rv:.3e}", flush=True)
        if not (torch.isfinite(p).all() and torch.isfinite(v).all()):
            fail(f"fused {label} N={n}: non-finite state")
        if rp > REL_TOL or rv > REL_TOL:
            fail(f"fused {label} disagrees with its plain version at N={n}")
        if not (torch.equal(p, p2) and torch.equal(v, v2)):
            fail(f"fused {label} N={n}: two launches on one input differ")
        del p, v, p2, v2, p_ref, v_ref
        ms[label] = time_ms(lambda: fused_block.fused_block(*args), reps=5)
        ms[f"{label}_plain"] = time_ms(
            lambda: fused_block.fused_block_plain(*args), reps=2)
        print(f"fused block N={n} {label}, {BLOCK} steps: kernel "
              f"{ms[label]:.4f} ms, plain {ms[f'{label}_plain']:.4f} ms; "
              f"{BLOCK * n * n / ms[label] / 1e6:.1f} Gpairs/s (N^2 model) "
              f"{tag}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "sym_pairs_kernel+sym_reduce_kernel (Kernel B)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/sym.cu",
         "replaces": "nbody_tpu/ops/pallas_sym.py:85",
         "launches": launches["B"], "max_abs_err": err["B"],
         "ms": ms["B"], "plain_ms": ms["B_plain"]},
        {"name": "tiled_accel_kernel (Kernel A)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/tiled.cu",
         "replaces": "nbody_tpu/ops/pallas_kernel.py:58",
         "launches": launches["A"], "max_abs_err": err["A"],
         "ms": ms["A"], "plain_ms": ms["A_plain"]},
        {"name": "fused_rows_kernel (fused block, rows layout)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/fused.cu",
         "replaces": "nbody_tpu/ops/fused_block.py:163",
         "launches": launches["rows"], "max_abs_err": err["rows"],
         "ms": ms["rows"], "plain_ms": ms["rows_plain"]},
        {"name": "fused_cols_kernel (fused block, columns layout)",
         "route": "cuda", "source": "nbody_tpu_torch/csrc/fused.cu",
         "replaces": "nbody_tpu/ops/fused_block.py:78",
         "launches": launches["columns"], "max_abs_err": err["columns"],
         "ms": ms["columns"], "plain_ms": ms["columns_plain"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"# chip_smoke.py: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
