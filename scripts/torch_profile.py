#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port (``nbody_tpu_torch``), on one
CUDA card.

    python scripts/torch_profile.py [CELL ...]

For each cell it runs the engine's sample blocks (with the per-block mesh
env for the mesh tiers) and prints:

* the wall time of one block (host clock around blocks that end in a
  synchronize, median of 5, unprofiled) and per step;
* the device time of one block summed over its kernels and copies
  (``torch.profiler``) and the idle share, 1 - device time / wall time;
* the kernels that take the most device time;
* for the mesh cells and differentiable P3M, the device time of each
  stage inside the profiled block, per step: each kernel counts for the
  innermost of the program's own ``nbt.*`` spans
  (``nbody_tpu_torch/utils/spans.py``: ``mesh.env``, ``mesh.box``,
  ``mesh.deposit``, ``mesh.fft``, ``mesh.grids`` (the open boundary's
  spectrum products), ``mesh.ifft``, ``mesh.gather``,
  ``mesh.ghosts``, ``p3m.bin``, ``p3m.worklist``, ``sr``, the backward's
  ``sr.vjp``, and ``accel`` and ``block`` for what no stage holds; "none"
  for the rest of a backward) whose device
  interval holds it; and every transform kernel of the block, whichever
  stage ran it; and the host syncs a step (``spans.counts``), and for
  periodic P3M the ghost images one health check counts
  (``spans.counts["ghost_images"]``) and its second binnings at 7 N
  (``["health_full_bins"]``);
* for the mesh cells, each stage of one step alone (CUDA events, mean of
  10): the block env (box and kernel spectra), the robust box, the deposit,
  the forward transform, the three inverse transforms, the gather, the
  P3M pack, the worklist and the short-range kernel; and beside the
  deposit (the fixed-point kernel, ``csrc/deposit.cu``) the deposit under
  autograd (``_scatter``'s accumulating ``index_put_``) and an atomic
  ``index_add_`` (not used by the port: its sums come in another order
  each run);
* for every cell, the kernels a step (the profiled block's device events
  but copies and memsets), and the device ops a step with them;
* for the mesh cells, the deposit kernel's launches a force call (one a
  step: ``deposit_kernel.launches`` over the profiled blocks; one more a
  step in which a body overflows its cell) and the far field's (one a
  force call on the open boundary: ``far_field_kernel.launches``, the
  target kernel, after a memset and the moments kernel; none periodic),
  and for differentiable P3M its
  launches in a forward (none: autograd records the deposit, so
  ``_scatter`` runs);
* for the fused cells, the force sweeps a launch runs
  (``spans.counts["fused_sweeps"]`` over the profiled blocks: the block's
  steps under Euler);
* for the P3M cells, the worklist's runs (one a target slab) and the
  short-range kernel's time in every layout, each at its own suggested
  plan.

The cells: the exact path at N=2000 and N=16384 (``auto``, and the fused
rows and columns blocks at N=16384, the columns at tiles 64 x 256), 50-step
blocks; ``pallas_mxu`` and ``auto`` in
bf16 at N=16384, 50-step blocks; ``auto`` in bf16 at N=131072, 10-step
blocks; ``pallas_sym`` at N=1048576, whose partials run in bands, one-step
blocks; the particle decomposition at
N=2000 and N=16384 over 4 virtual shards of the card in each comm mode
(``allgather``, ``ring``, ``ring_sym``, ``rdma``) and ``rdma`` over 3 at
N=2000, 50-step blocks; P3M on the Plummer sphere of the JAX package's
gate (N=262144, seed 7, ng=128, cutoff 4), 8-step blocks; P3M and PM on
the reference initial conditions at N=1048576, 4-step blocks, with the
open boundary and with the periodic one (bench.py:48-49's row: L = 1;
its stages are the deposit, the transforms, the gather, the ghost images
and the pack, and alone also the spectra it builds once a run).  Then the
pair-symmetric kernels called alone through their wrappers, 20 calls in a
row (a "step" is one call, so wall - device per call is the host's gap
between calls): Kernel B at N=16384, and the two-sided sweep at one
``ring_sym`` block pair of N=16384 over 4 (4096 x 4096) and of N=2000
over 4 (512 x 512), which splits a call into the pairs kernel, the reduce
kernel and the host gap.  Then differentiable P3M
(``make_accel_fn("p3m", differentiable=True)``, at the plan of
``suggest_sr_plan(..., differentiable=True)``) at the Plummer gate and on
bench.py:48-49's periodic row: one step's forward, one step's forward and
backward of mean(|a|^2) (the backward's device time is the difference), and
at the gate a 10-step Euler rollout gradient with remat (a "step" is one
rollout step).  Each engine cell is built by the engine
(``simulation._DeviceRunner``: its state, P3M plan, mesh env and
blocks).  The first line is the card's
name and power limit.  With CELL arguments it runs only the cells whose
label contains one of them (``"16384 pallas_mxu" "shards=4"``).  Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def profile_block(label: str, block, state, steps: int,
                  stages: bool = False) -> None:
    """Wall time, device time and idle share of one block; top kernels;
    with ``stages``, the device time of each of the program's spans inside
    the profiled block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nbody_tpu_torch.utils.spans import PREFIX

    block(state)
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        block(state)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block(state)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # The program's spans also show on the device timeline as annotations:
    # they are spans, not kernels.
    kernels = [e for e in prof.events() if e.device_type == cuda
               and not e.name.startswith(PREFIX)]
    busy = 1e-3 * sum(e.device_time_total for e in kernels)
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + 1e-3 * e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    # Kernels a step: the device's events but copies and memsets.
    launched = sum(not e.name.startswith(("Memcpy", "Memset"))
                   for e in kernels)
    print(f"{label}: block {wall:.3f} ms wall ({wall / steps:.3f} per step), "
          f"device {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
          f"{launched / steps:.1f} kernels a step ({len(kernels) / steps:.1f} "
          "device ops with copies and memsets)", flush=True)
    for name, (n, t) in top:
        print(f"    {t:9.3f} ms  {n:5d} x  {name[:90]}", flush=True)
    if stages:
        # A span's device interval runs from its first kernel to its last
        # (one stream, so no other stage's kernel runs inside it), and the
        # spans nest (block > accel > mesh.deposit): each kernel counts for
        # the shortest span that holds it.
        spans = [(e.time_range.end - e.time_range.start, e.time_range.start,
                  e.time_range.end, e.name[len(PREFIX):])
                 for e in prof.events() if e.device_type == cuda
                 and e.name.startswith(PREFIX)]
        per: dict = {}
        for k in kernels:
            mid = 0.5 * (k.time_range.start + k.time_range.end)
            name = min(((d, n) for d, s0, s1, n in spans if s0 <= mid <= s1),
                       default=(0, "none"))[1]
            per[name] = per.get(name, 0.0) + 1e-3 * k.device_time_total
        fft = 1e-3 * sum(k.device_time_total for k in kernels
                         if "fft" in k.name)
        print(f"{label} stages in the block (profiler, device ms per step): "
              + ", ".join(f"{k} {v / steps:.3f}" for k, v in
                          sorted(per.items(), key=lambda kv: -kv[1]))
              + f"; every transform kernel, wherever it ran "
              f"{fft / steps:.3f}", flush=True)


def mesh_stages(label: str, runner) -> None:
    """Each stage of one mesh step alone, at the step's shapes, on the
    runner's state with its plan; for P3M, the short-range kernel in every
    layout at that layout's own plan."""
    import torch

    from nbody_tpu_torch.ops import pm, sr_kernel

    cfg = runner.cfg
    pos, mass = runner.state.pos, runner.state.mass
    grid, cutoff = cfg.mesh_params()
    env_fn = runner._mesh_env_fn()
    env = env_fn(pos, mass)
    mesh = pm._OpenMesh(grid, env["lo_box"], env["hi_box"])
    lo, inv_h = mesh.lo, mesh.inv_h
    m = 2 * grid
    rho = pm._deposit(pos, mass, lo, inv_h, grid)
    rho_hat = torch.fft.rfftn(rho, s=(m, m, m))
    spectra = env["spectra"][0] if cutoff else env["spectra"]
    grids = pm._inverse([rho_hat * k for k in spectra], grid)

    def deposit_index_add():
        idx, val = [], []
        for flat, w in pm._corner_iter(*pm._cic_weights(pos, lo, inv_h, grid),
                                       grid):
            idx.append(flat)
            val.append(mass * w)
        return torch.zeros(grid ** 3, device=pos.device).index_add_(
            0, torch.cat(idx), torch.cat(val))

    ms = {
        "env": cuda_ms(lambda: env_fn(pos, mass), 3),
        "box": cuda_ms(lambda: pm._robust_box(pos, mass)),
        "deposit": cuda_ms(lambda: pm._deposit(pos, mass, lo, inv_h, grid)),
        "deposit by index_put_ (_scatter)": cuda_ms(lambda: pm._scatter(
            pm._corner_iter(*pm._cic_weights(pos, lo, inv_h, grid), grid),
            mass, grid)),
        "deposit by index_add_": cuda_ms(deposit_index_add),
        "rfftn": cuda_ms(lambda: torch.fft.rfftn(rho, s=(m, m, m))),
        "3 irfftn": cuda_ms(lambda: pm._inverse(
            [rho_hat * k for k in spectra], grid)),
        "gather": cuda_ms(lambda: pm._gather(grids, pos, lo, inv_h, grid)),
    }
    if cutoff:
        cap, s_max, e_max = cfg.pm_capacity, cfg.pm_sr_slabs, cfg.pm_sr_entries
        sym, paired = pm._active_sr_layout(pos.is_cuda)
        # The solver's geometry and cells on the env's box, the pack alone.
        geom = mesh.geom(cutoff)
        cid = pm._sr_candidates(mesh, geom, *mesh.bodies(pos, mass, pos)[:2],
                                0)[3]

        def pack():
            return pm._sr_pack(cid, pos, mass, geom.nc ** 3, cap, s_max,
                               pm._subcell_key(pos, geom.lo, geom.span,
                                               geom.nc))
        tabs = pack()
        wl_t, wl_s, n_e = pm._sr_ranges(tabs[2], tabs[3], geom.nc, geom.sub,
                                        e_max, symmetric=sym, paired=paired)
        bounds = torch.stack([torch.zeros_like(n_e), n_e.clamp(max=e_max)])
        ms["pack"] = cuda_ms(pack)
        ms["worklist"] = cuda_ms(lambda: pm._sr_ranges(
            tabs[2], tabs[3], geom.nc, geom.sub, e_max, symmetric=sym,
            paired=paired))
        ms["sr kernel"] = cuda_ms(lambda: sr_kernel.sweep(
            tabs[0], tabs[1], wl_t, wl_s, bounds, geom.rc2, symmetric=sym,
            paired=paired))
        over = float(pm.cell_overflow_fraction(pos, mass, grid, cutoff, cap))
        _, runs = torch.unique_consecutive(wl_t[:int(n_e)],
                                           return_counts=True)
        print(f"{label}: plan capacity={cap} slabs={s_max} entries={e_max}, "
              f"{int(n_e)} entries, layout symmetric={sym} paired={paired}, "
              f"cell overflow {over:.4f}; {runs.numel()} runs, mean "
              f"{float(runs.float().mean()):.2f} entries, longest "
              f"{int(runs.max())}", flush=True)
        times = []
        for layout, (lsym, lpaired) in pm.SR_LAYOUTS.items():
            if layout == "xla":  # the kernel's plain layout, as "pallas"
                continue
            lplan = pm.suggest_sr_plan(pos, mass, grid, cutoff, layout=layout)
            pk = pm.sr_pack_inputs(pos, mass, grid=grid, cutoff_cells=cutoff,
                                   symmetric=lsym, paired=lpaired, **lplan)
            lb = torch.stack([torch.zeros_like(pk["n_e"]), pk["n_e"]])
            t = cuda_ms(lambda: sr_kernel.sweep(
                pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], lb, pk["rc2"],
                symmetric=lsym, paired=lpaired), 5)
            times.append(f"{layout} {int(pk['n_e'])} entries {t:.3f}")
            del pk
        print(f"{label} sr kernel by layout (ms): " + ", ".join(times),
              flush=True)
    print(f"{label} stages alone (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)


def periodic_mesh_stages(label: str, runner) -> None:
    """Each stage of one periodic mesh step alone, at the step's shapes, on
    the runner's state with its plan: the spectra's build (once a run), the
    wrap, the deposit, the forward and the three inverse transforms, the
    gather; for P3M the ghost images, the tables (binning, pack and
    worklist, ghosts included) and the short-range kernel."""
    import torch

    from nbody_tpu_torch.ops import pm, sr_kernel

    cfg = runner.cfg
    pos, mass = runner.state.pos, runner.state.mass
    grid, cutoff = cfg.mesh_params()
    box = cfg.pm_box
    env = runner._mesh_env_fn()(pos, mass)
    spectra = env["spectra"][0] if cutoff else env["spectra"]
    rho = pm._deposit_periodic(pos, mass, box, grid)
    rho_hat = torch.fft.rfftn(rho)
    grids = pm._periodic_inverse([rho_hat * k for k in spectra], grid)
    ms = {
        "spectra (once a run)": cuda_ms(lambda: pm._make_periodic_env(
            grid, cutoff, box, pos.device), 3),
        "wrap": cuda_ms(lambda: pm._wrap_box(pos, box)),
        "deposit": cuda_ms(lambda: pm._deposit_periodic(pos, mass, box,
                                                        grid)),
        "deposit by index_put_ (_scatter)": cuda_ms(lambda: pm._scatter(
            pm._periodic_corners(pos, box, grid), mass, grid)),
        "rfftn": cuda_ms(lambda: torch.fft.rfftn(rho)),
        "3 irfftn": cuda_ms(lambda: pm._periodic_inverse(
            [rho_hat * k for k in spectra], grid)),
        "gather": cuda_ms(lambda: pm._gather_periodic(grids, pos, box, grid)),
    }
    if cutoff:
        sym, paired = pm._active_sr_layout(pos.is_cuda)
        plan = dict(capacity=cfg.pm_capacity, sr_slabs=cfg.pm_sr_slabs,
                    sr_entries=cfg.pm_sr_entries, sr_ghosts=cfg.pm_sr_ghosts)
        bkw = dict(boundary="periodic", box_size=box)
        rc = pm._periodic_geom(grid, cutoff, box, pos.device)[2]
        tabs = pm.sr_pack_inputs(pos, mass, grid, cutoff, symmetric=sym,
                                 paired=paired, **plan, **bkw)
        n_e = tabs["n_e"]
        bounds = torch.stack([torch.zeros_like(n_e),
                              n_e.clamp(max=tabs["e_max"])])
        ms["ghosts"] = cuda_ms(lambda: pm._ghost_images(
            tabs["src_w"], mass, box, rc, tabs["gcap"]))
        ms["tables"] = cuda_ms(lambda: pm.sr_pack_inputs(
            pos, mass, grid, cutoff, symmetric=sym, paired=paired, **plan,
            **bkw))
        ms["sr kernel"] = cuda_ms(lambda: sr_kernel.sweep(
            tabs["ptab"], tabs["mtab"], tabs["wl_t"], tabs["wl_s"], bounds,
            tabs["rc2"], symmetric=sym, paired=paired))
        n = pos.shape[1]
        print(f"{label}: plan {plan}, {int(tabs['n_ghost'])} ghosts "
              f"({int(tabs['n_ghost']) / n:.4f} N), "
              f"{tabs['ptab'].shape[1]} slots, {int(n_e)} entries, layout "
              f"symmetric={sym} paired={paired}", flush=True)
    print(f"{label} stages alone (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nbody_tpu_torch import SimConfig
    from nbody_tpu_torch.ops import deposit_kernel, far_field_kernel
    from nbody_tpu_torch.simulation import _DeviceRunner
    from nbody_tpu_torch.utils import spans

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for label, steps, kw in (
            ("N=2000 auto", 50, dict(n=2000)),
            ("N=16384 auto", 50, dict(n=16384)),
            ("N=16384 fused rows", 50, dict(n=16384, fused=True)),
            ("N=16384 fused columns", 50, dict(n=16384, fused=True, tile_i=64,
                                                tile_j=256)),
            ("N=16384 pallas_mxu", 50, dict(n=16384, kernel="pallas_mxu")),
            ("N=16384 auto bf16", 50, dict(n=16384, precision="bf16")),
            ("N=131072 auto bf16", 10, dict(n=131072, precision="bf16")),
            ("N=1048576 pallas_sym", 1, dict(n=1048576, kernel="pallas_sym")),
            *((f"N={n} shards={k} {comm}", 50, dict(n=n, shards=k,
                                                     comm=comm))
              for n, k, comm in (
                  *((n, 4, c) for n in (2000, 16384)
                    for c in ("allgather", "ring", "ring_sym", "rdma")),
                  (2000, 3, "rdma"))),
            ("p3m plummer N=262144", 8, dict(n=262144, kernel="p3m",
                                              distribution="plummer", seed=7)),
            ("p3m reference N=1048576", 4, dict(n=1048576, kernel="p3m")),
            ("pm reference N=1048576", 4, dict(n=1048576, kernel="pm")),
            ("p3m periodic reference N=1048576", 4, dict(
                n=1048576, kernel="p3m", pm_boundary="periodic",
                pm_box=1.0)),
            ("pm periodic reference N=1048576", 4, dict(
                n=1048576, kernel="pm", pm_boundary="periodic",
                pm_box=1.0))):
        if sys.argv[1:] and not any(c in label for c in sys.argv[1:]):
            continue
        # The engine's own blocks, plan and mesh env; prepare() runs the
        # warm-up block.
        runner = _DeviceRunner(SimConfig(nsteps=steps, sfreq=steps, **kw))
        runner.prepare()
        mesh = runner._mesh_env_fn() is not None
        periodic = runner.cfg.pm_boundary == "periodic"
        syncs = spans.counts["host_syncs"]
        sweeps = spans.counts["fused_sweeps"]
        deposit_kernel.launches = far_field_kernel.launches = 0
        try:
            profile_block(f"{label}, {steps} steps", runner._block_for(steps),
                          runner.state, steps, stages=mesh)
            syncs = spans.counts["host_syncs"] - syncs
            if runner.cfg.fused:
                # Seven blocks, as below: one launch each.
                sweeps = spans.counts["fused_sweeps"] - sweeps
                print(f"{label}: {sweeps / 7:.1f} force sweeps a fused "
                      f"launch ({sweeps / (7 * steps):.3f} a step)",
                      flush=True)
            if mesh:
                # Seven blocks: the warm one, five timed, one profiled; one
                # force call a step (Euler).
                print(f"{label}: {syncs / (7 * steps):.3f} host syncs a step "
                      "(the block's, its KE read and health check not "
                      f"included); {deposit_kernel.launches / (7 * steps):.3f}"
                      " deposit kernel launches a force call, "
                      f"{far_field_kernel.launches / (7 * steps):.3f} "
                      "far-field target kernel launches a force call (open: "
                      "one, after a memset and the moments kernel)",
                      flush=True)
                if periodic and runner._sr_health:
                    images = spans.counts["ghost_images"]
                    full = spans.counts["health_full_bins"]
                    runner.check_sr_health()
                    images = spans.counts["ghost_images"] - images
                    full = spans.counts["health_full_bins"] - full
                    print(f"{label}: the health check counts {images} ghost "
                          f"images ({images / runner.cfg.n:.4f} N) and bins "
                          f"{full} times again at 7 N", flush=True)
                (periodic_mesh_stages if periodic else mesh_stages)(label,
                                                                     runner)
        finally:
            runner.finish()
        del runner
    grad_cells()
    call_cells()
    return 0


def grad_cells() -> None:
    """Differentiable P3M: one step forward, forward and backward, and (at
    the Plummer gate) a 10-step rollout gradient."""
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.models.gravity import make_accel_fn
    from nbody_tpu_torch.models.rollout import make_rollout_fn
    from nbody_tpu_torch.ops import deposit_kernel, pm

    dev = torch.device("cuda", 0)
    pos, vel, mass = (torch.tensor(a, device=dev)
                      for a in distributions.plummer(262144, seed=7))
    ref = make_state(1048576, device=dev)
    periodic = dict(boundary="periodic", box_size=1.0)
    for label, (p, v, m), bkw in (
            ("p3m grad plummer N=262144", (pos, vel, mass), {}),
            ("p3m grad periodic reference N=1048576",
             (ref.pos, ref.vel, ref.mass), periodic)):
        if sys.argv[1:] and not any(c in label for c in sys.argv[1:]):
            continue
        plan = pm.suggest_sr_plan(p, m, 128, 4, differentiable=True, **bkw)
        fn = make_accel_fn("p3m", differentiable=True, grid=128, **plan,
                           **bkw)

        def forward(_, p=p, m=m, fn=fn):
            q = p.clone().requires_grad_(True)
            return torch.mean(fn(q, m) ** 2)

        deposit_kernel.launches = 0
        profile_block(f"{label}, forward", forward, None, 1, stages=True)
        # Seven forwards: the warm one, five timed, one profiled.
        print(f"{label}: {deposit_kernel.launches / 7:.3f} deposit kernel "
              "launches a forward", flush=True)
        profile_block(f"{label}, forward and backward",
                      lambda s: forward(s).backward(), None, 1, stages=True)
        if bkw:
            continue
        rollout = make_rollout_fn(fn, 0.01, 10)
        with torch.no_grad():
            target = rollout(p, v, m)[0]

        def rollout_grad(_):
            v0 = (0.5 * v).requires_grad_(True)
            torch.sum((rollout(p, v0, m)[0] - target) ** 2).backward()

        profile_block(f"{label}, 10-step rollout gradient", rollout_grad,
                      None, 10, stages=True)


def call_cells() -> None:
    """The pair-symmetric kernels alone, 20 wrapper calls a block."""
    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import sym_kernel
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.parallel.decompose import shard_state

    calls = 20
    big = make_state(16384, device="cuda")
    sh, _ = shard_state(big, 4, make_mesh(4))
    small = make_state(2000, pad_multiple=512, device="cuda")
    sh2, _ = shard_state(small, 4, make_mesh(4))
    for label, fn, args in (
            ("Kernel B N=16384", sym_kernel.accelerations,
             (big.pos, big.mass)),
            ("two-sided 4096 x 4096 (N=16384 over 4)",
             sym_kernel.accelerations_two_sided,
             (sh.pos[0], sh.mass[0], sh.pos[1], sh.mass[1])),
            ("two-sided 512 x 512 (N=2000 over 4)",
             sym_kernel.accelerations_two_sided,
             (sh2.pos[0], sh2.mass[0], sh2.pos[1], sh2.mass[1]))):
        if sys.argv[1:] and not any(c in label for c in sys.argv[1:]):
            continue

        def block(_, fn=fn, args=args):
            for _ in range(calls):
                fn(*args)

        profile_block(f"{label}, {calls} calls", block, None, calls)


if __name__ == "__main__":
    sys.exit(main())
