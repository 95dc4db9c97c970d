"""The simulation engine, the GSimulation analog.

Owns the run lifecycle of the reference's ``GSimulation::start()``
(ver0/GSimulation.cpp:95-213), as ``nbody_tpu.simulation`` does: build the
state, print the header, run the sample-block loop with per-block timing
and GFlop/s statistics, print the footer.

* A sample block (sfreq steps) of the exact kernels runs on the device
  with no host sync; the host syncs once per block, when it reads the
  kinetic energy.  The mesh tiers sync inside the step too (``ops/pm.py``);
  every sync sits in a counted ``utils/spans.sync``, and the block, the
  force calls and the health check in ``spans.span`` ranges, which a
  ``torch.profiler`` session (``profile_dir``) records.
* A warm-up block runs before the clock starts: it builds the CUDA kernels
  and runs one block, and its result is discarded.
* ``SimConfig.fused`` runs each sample block as one launch of the fused
  block (``ops/fused_block.py``) instead of a loop of force sweeps; f32
  only, and ``kernel`` then sets nothing: the padding follows the layout.
* The statistics replicate the reference's: per-block
  ``gflops*sfreq/block_seconds`` with running mean/stddev that exclude the
  first two sample blocks (ver0/GSimulation.cpp:186-203).
* ``SimConfig.shards`` > 1 shards the state over K slots of the card (or
  of the CPU) and runs each block through the comm mode's sharded block
  (``parallel/decompose.py``); the energy check works on the whole state.
* ``SimConfig.energy_check`` reports the total-energy (KE + PE) drift over
  the run: E0 is taken before the header and E1 after the footer, both
  outside the clock.
* ``SimConfig.profile_dir`` writes a ``torch.profiler`` trace of the
  run, set-up (``nbt.setup.*``) and sample blocks (CPU and, on the card,
  CUDA activity) into the directory, as the JAX engine's
  ``jax.profiler.trace``; ``SimConfig.debug_nans``
  raises ``FloatingPointError`` when a sample block ends with a non-finite
  position, velocity or kinetic energy, checked where the host reads the
  energy.
* The mesh tiers (``pm``, ``p3m``): the P3M plan is measured on the initial
  state before the warm-up (the layout first, then
  ``SimConfig.resolve_sr_plan``); each open-boundary block freezes the mesh
  box and kernel spectra at its entry (``pm.make_mesh_env``); after each
  sample block a health check re-measures the overflow (cells, worklist
  entries and, periodic, ghost images) on the current state and warns
  once, or under ``pm_replan`` grows the plan and rebuilds the blocks.
* The periodic boundary (``pm_boundary="periodic"``): the spectra are
  constants of (box, grid, cutoff), so one periodic env is built a run and
  handed to every block.  The JAX engine passes none there, because XLA
  hoists the spectra out of its compiled block; eager PyTorch hoists
  nothing, and without an env each step would rebuild them.  The energy
  check takes the mesh-solved periodic potential energy.

The JAX engine's autotune, online retune, checkpoint and ref64 branches,
its multi-process runs and sharded mesh solve are not ported yet
(ROADMAP.md queue 1);
its watchdog branches, the fused block's pair budget and the mesh-step
estimate among them, are not ported at all (ROADMAP.md "What is not
ported").
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import SimConfig
from .init import make_state
from .models.gravity import (
    kinetic_energy,
    make_accel_fn,
    make_block_fn,
    make_fused_block_fn,
    potential_energy,
)
from .utils import reporting, spans
from .utils.flops import step_gflops
from .utils.timer import WallTime


@dataclasses.dataclass
class RunResult:
    samples: List[Tuple[int, float, float, float, float]]
    # each: (step, phys_time, kenergy, block_seconds, block_gflops)
    total_time: float
    av: float
    dev: float
    nthreads: int
    device: str = ""  # what ran the blocks: "cpu" or the card's name
    energy_drift: Optional[float] = None  # set when energy_check is on

    @property
    def kenergy_trace(self) -> List[Tuple[int, float]]:
        return [(s, ke) for (s, _, ke, _, _) in self.samples]

    def to_dict(self) -> dict:
        return dict(
            samples=[
                dict(step=s, t_phys=t, kenergy=ke, seconds=b, gflops=g)
                for (s, t, ke, b, g) in self.samples
            ],
            total_time=self.total_time,
            gflops_mean=self.av,
            gflops_dev=self.dev,
            nthreads=self.nthreads,
            device=self.device,
            energy_drift=self.energy_drift,
        )


class _DeviceRunner:
    """Produces (state, kenergy) per sample block on one device."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        self.device = cfg.device()
        self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
        # A ParticleState, or a ShardedState when cfg.shards > 1.
        self.state = None
        self.mesh = None  # the shard mesh when cfg.shards > 1
        self._blocks = {}
        self._sr_health = False  # per-block P3M plan health check
        self._sr_warned = False
        self._sr_layout_prev = None  # pm layout to restore after the run
        self._periodic_env = None  # the run's periodic mesh env, once built

    def finish(self) -> None:
        """Restore the pm layout a forced ``pm_sr_layout`` replaced."""
        if self._sr_layout_prev is not None:
            from .ops import pm

            pm.set_sr_layout(self._sr_layout_prev)
            self._sr_layout_prev = None

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def _block_for(self, steps: int):
        if steps not in self._blocks:
            cfg = self.cfg
            if self.mesh is not None:
                from .parallel.decompose import make_sharded_block_fn

                self._blocks[steps] = make_sharded_block_fn(
                    cfg.kernel, cfg.kernel_opts(), cfg.dt, steps, self.mesh,
                    comm=cfg.comm, integrator=cfg.integrator,
                )
            elif cfg.fused:
                self._blocks[steps] = make_fused_block_fn(
                    cfg.dt, steps, tile_i=cfg.tile_i, tile_j=cfg.tile_j,
                    integrator=cfg.integrator,
                )
            else:
                self._blocks[steps] = make_block_fn(
                    self.accel_fn, cfg.dt, steps, integrator=cfg.integrator,
                    env_fn=self._mesh_env_fn(),
                )
        return self._blocks[steps]

    def _mesh_env_fn(self):
        """The mesh environment (pm.make_mesh_env) for the mesh tiers, else
        None: built at each block's entry under the open boundary; under
        the periodic one built at the first block's and handed to every
        block after it, the same object for the whole run."""
        cfg = self.cfg
        if cfg.resolved_kernel() not in ("pm", "p3m"):
            return None
        from .ops import pm

        grid, cutoff = cfg.mesh_params()
        if cfg.pm_boundary != "periodic":
            return lambda pos, mass: pm.make_mesh_env(
                pos, mass, grid=grid, cutoff_cells=cutoff)

        def periodic_env(pos, mass):
            if self._periodic_env is None:
                self._periodic_env = pm.make_mesh_env(
                    pos, mass, grid=grid, cutoff_cells=cutoff,
                    boundary="periodic", box_size=cfg.pm_box)
            return self._periodic_env

        return periodic_env

    def prepare(self) -> None:
        cfg = self.cfg
        with spans.span("setup.state"):
            self.state = make_state(
                cfg.n, pad_multiple=cfg.pad_multiple(),
                distribution=cfg.distribution, seed=cfg.seed,
                device=self.device,
            )
        resolved = cfg.resolved_kernel()
        if resolved == "p3m" or (resolved == "pm" and cfg.pm_cutoff):
            # The plan sizes static tables and the worklist from the
            # concrete state, for the layout that will run: the layout
            # lands first.
            if cfg.pm_sr_layout:
                from .ops import pm

                self._sr_layout_prev = pm.set_sr_layout(cfg.pm_sr_layout)
            with spans.span("setup.plan"):
                cfg.resolve_sr_plan(self.state.pos, self.state.mass)
            self._sr_health = cfg.nsteps > 0
            self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())
        if cfg.shards > 1:
            from .parallel.decompose import shard_state
            from .parallel.mesh import make_mesh

            self.mesh = make_mesh(cfg.shards, [self.device] * cfg.shards)
            self.state, _ = shard_state(self.state, cfg.shards, self.mesh)
        # Warm-up: builds the kernels at first use and runs one block; the
        # block does not touch its input, so the state stays as it was.
        with spans.span("setup.warm"):
            _, ke = self._block_for(min(cfg.sfreq, cfg.nsteps))(self.state)
            with spans.sync("ke"):
                float(ke)

    # Cell-overflow fraction above which the measured P3M plan is declared
    # degraded (overflowed particles fall back to mesh-quality forces).
    SR_HEALTH_MAX_OVERFLOW = 0.005

    def check_sr_health(self) -> None:
        """After each sample block, the P3M plan health check.  The plan was
        measured on the initial state, but clustering evolves: check cell,
        worklist and (periodic) ghost overflow on the current state, and
        warn once, or under ``pm_replan`` re-measure the plan, grow it
        (never shrink) and rebuild the blocks."""
        if not self._sr_health:
            return
        with spans.span("health"):
            self._check_sr_health()

    def _check_sr_health(self) -> None:
        from .ops import pm

        cfg = self.cfg
        grid, cutoff = cfg.mesh_params()
        pos, mass = self.state.pos, self.state.mass
        bkw = dict(boundary=cfg.pm_boundary, box_size=cfg.pm_box)
        periodic = cfg.pm_boundary == "periodic"
        # Dropped ghosts and worklist entries lose their whole short-range
        # term, so any is degradation.
        frac, ghosts, entries = pm.sr_plan_health(
            pos, mass, grid, cutoff, capacity=cfg.pm_capacity,
            sr_slabs=cfg.pm_sr_slabs, sr_entries=cfg.pm_sr_entries,
            sr_ghosts=cfg.pm_sr_ghosts, **bkw)
        if frac <= self.SR_HEALTH_MAX_OVERFLOW and not ghosts and not entries:
            return
        detail = (f"cell overflow {frac:.1%}"
                  + (f", {ghosts} ghost images dropped" if ghosts else "")
                  + (f", {entries} worklist entries dropped" if entries
                     else ""))
        if not cfg.pm_replan:
            if not self._sr_warned:
                self._sr_warned = True
                print(f"# p3m plan health: {detail} on the current state "
                      "— the measured plan no longer fits (accuracy degrades "
                      "toward pure PM for the overflowed pairs"
                      + (";\n# dropped ghosts lose their short-range term "
                         "entirely" if ghosts else "")
                      + (";\n# dropped worklist entries lose their "
                         "short-range term entirely" if entries else "")
                      + ").  Rerun with --pm-replan to re-measure mid-run, "
                      "or raise --pm-capacity.", file=sys.stderr)
            return
        plan = pm.suggest_sr_plan(pos, mass, grid, cutoff, **bkw)
        cap = max(cfg.pm_capacity, plan["capacity"])
        if cap != plan["capacity"]:
            # Slabs and entries measured at the capacity the rebuilt blocks
            # will bin with.
            plan = pm.suggest_sr_plan(pos, mass, grid, cutoff, capacity=cap,
                                      **bkw)
        grown = dict(
            pm_capacity=max(cfg.pm_capacity, plan["capacity"]),
            pm_sr_slabs=max(cfg.pm_sr_slabs, plan["sr_slabs"]),
            pm_sr_entries=max(cfg.pm_sr_entries, plan["sr_entries"]),
            pm_sr_ghosts=max(cfg.pm_sr_ghosts, plan.get("sr_ghosts", 0)))
        if all(grown[k] == getattr(cfg, k) for k in grown):
            if not self._sr_warned:
                self._sr_warned = True
                print(f"# p3m plan health: {detail}, but a re-measured plan "
                      "is no larger than the current one — raise "
                      "--pm-capacity explicitly if this persists.",
                      file=sys.stderr)
            return
        for k, v in grown.items():
            setattr(cfg, k, v)
        self._sr_warned = False
        print(f"# p3m plan health: {detail} — replanned to "
              f"capacity={cfg.pm_capacity} slabs={cfg.pm_sr_slabs} "
              f"entries={cfg.pm_sr_entries}"
              + (f" ghosts={cfg.pm_sr_ghosts}" if periodic else "")
              + " (blocks rebuild on next sample block)", file=sys.stderr)
        self._blocks.clear()
        self.accel_fn = make_accel_fn(cfg.kernel, **cfg.kernel_opts())

    def run_block(self, steps: int) -> float:
        with spans.span("block"):
            self.state, ke = self._block_for(steps)(self.state)
            # float() copies the block's kinetic energy to the host: the
            # block's own sync.
            with spans.sync("ke"):
                return float(ke)

    def check_finite(self, ke: float, step: int) -> None:
        """``--debug-nans``: raise if the block ending at ``step`` left a
        non-finite position, velocity or kinetic energy."""
        state = self.state
        for name, xs in (("position", state.pos), ("velocity", state.vel)):
            for x in xs if isinstance(xs, tuple) else (xs,):
                finite = torch.isfinite(x).all()
                with spans.sync("finite"):
                    finite = bool(finite)
                if not finite:
                    raise FloatingPointError(
                        f"--debug-nans: non-finite {name} after step {step}")
        if not math.isfinite(ke):
            raise FloatingPointError(
                f"--debug-nans: non-finite kinetic energy {ke} after step "
                f"{step}")

    def profile(self):
        """A ``torch.profiler`` context over the run, set-up included,
        that writes its trace into ``SimConfig.profile_dir`` on exit, or a
        null context."""
        if not self.cfg.profile_dir:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, "trace.json")
        return profile(activities=acts,
                       on_trace_ready=lambda p: p.export_chrome_trace(path))

    def total_energy(self) -> float:
        """KE + PE of the current state (zero-mass padding adds nothing),
        on the whole state when it is sharded.  Under the periodic boundary
        the PE is the mesh-solved, background-subtracted one
        (pm.periodic_potential_energy): the open pairwise image sum
        diverges."""
        state = self.state
        if self.mesh is not None:
            from .parallel.decompose import unshard_state

            state = unshard_state(state)
        if self.cfg.pm_boundary == "periodic":
            from .ops import pm

            pe = pm.periodic_potential_energy(state.pos, state.mass,
                                              self.cfg.pm_box,
                                              self.cfg.mesh_params()[0])
            return float(kinetic_energy(state)) + float(pe)
        return float(kinetic_energy(state)) + float(potential_energy(state))


def run(cfg: SimConfig, out=None, quiet: bool = False) -> RunResult:
    runner = _DeviceRunner(cfg)
    try:
        # The profile holds set-up's spans (nbt.setup.*) and the blocks'.
        with runner.profile():
            return _run_prepared(runner, cfg, out, quiet)
    finally:
        # A forced SR layout applies to this run only.
        runner.finish()


def _run_prepared(runner: _DeviceRunner, cfg: SimConfig, out,
                  quiet: bool) -> RunResult:
    emit = (lambda *_: None) if quiet else reporting.emit

    runner.prepare()
    e0 = runner.total_energy() if cfg.energy_check else None
    emit(reporting.header(cfg.n, cfg.nsteps, cfg.dt), out)

    gflops = step_gflops(cfg.n)
    timer = WallTime()
    samples: List[Tuple[int, float, float, float, float]] = []
    av = 0.0
    dev = 0.0
    nf = 0

    t0 = timer.start()
    s = 0
    while s < cfg.nsteps:
        steps = min(cfg.sfreq, cfg.nsteps - s)
        b0 = timer.start()
        ke = runner.run_block(steps)
        b1 = timer.stop()
        s += steps
        if cfg.debug_nans:
            runner.check_finite(ke, s)
        if steps == cfg.sfreq and s % cfg.sfreq == 0:
            nf += 1
            block_secs = b1 - b0
            block_gf = gflops * cfg.sfreq / block_secs
            t_phys = float(np.float32(s) * np.float32(cfg.dt))
            samples.append((s, t_phys, ke, block_secs, block_gf))
            emit(reporting.stats_row(s, t_phys, ke, block_secs, block_gf),
                 out)
            runner.check_sr_health()
            if nf > 2:
                av += block_gf
                dev += block_gf * block_gf
    t1 = timer.stop()

    total = t1 - t0
    if nf > 2:
        av /= nf - 2
        dev = math.sqrt(max(dev / (nf - 2) - av * av, 0.0))
    else:
        av = dev = float("nan")

    nthreads = cfg.shards
    emit(reporting.footer(nthreads, total, av, dev), out)
    result = RunResult(samples, total, av, dev, nthreads,
                       device=runner.device_name())
    if e0 is not None:
        e1 = runner.total_energy()
        drift = abs(e1 - e0) / max(abs(e0), 1e-30)
        result.energy_drift = drift
        emit(f"# Energy drift |dE/E|: {drift:.3e} "
             f"(E0={e0:.6g}, E1={e1:.6g})", out)
    return result


class Simulation:
    """Class-style facade mirroring the reference's GSimulation public API
    (ver0/GSimulation.hpp:36-80; ver5_all/GSimulation.hpp:40-65)."""

    def __init__(self, config: Optional[SimConfig] = None, quiet: bool = False):
        self.config = config or SimConfig()
        self._quiet = quiet
        self.world_rank = 0  # one process: the multi-process path is not ported
        self.world_size = 1
        self._banner_printed = False
        self.result: Optional[RunResult] = None

    def _print_banner_once(self) -> None:
        if not self._banner_printed and not self._quiet:
            reporting.print_banner()
        self._banner_printed = True

    def init_mpi(self) -> None:
        """The reference's ``init_mpi()`` (ver5_all/GSimulation.cpp:93-115).
        One process: prints the banner and nothing more.  ``--shards``
        shards the state inside this process; the multi-process bootstrap
        over ``torch.distributed`` is ROADMAP.md queue 1 item 11(b)."""
        self._print_banner_once()

    def set_number_of_particles(self, n: int) -> None:
        self.config.n = n

    def set_number_of_steps(self, nsteps: int) -> None:
        self.config.nsteps = nsteps

    def set_devices(self, n: int) -> None:
        """The reference's device selector (ver5_all/main.cpp:42-45):
        1 = cpu; 2 (gpu) and 3 (cpu+gpu) = the card."""
        if n == 1:
            self.config.platform = "cpu"
        elif n in (2, 3):
            self.config.platform = None

    def set_cpu_ratio(self, ratio: float) -> None:
        """ver5_all CLI parity (main.cpp:49).  The reference's OpenCL backend
        splits each step between CPU and GPU by this ratio; the port runs
        every step on one device, so the value is noted and not used."""
        self._cpu_ratio = ratio
        if not self._quiet:
            print(f"# cpu_ratio={ratio:g} noted: every step runs on one "
                  "device (no CPU/GPU co-execution)", file=sys.stderr)

    def set_thread_dim0(self, d: int) -> None:
        if d > 0:
            self.config.tile_i = d

    def set_thread_dim1(self, d: int) -> None:
        if d > 0:
            self.config.tile_j = d

    def start(self) -> RunResult:
        self._print_banner_once()
        self.result = run(self.config, quiet=self._quiet)
        return self.result
