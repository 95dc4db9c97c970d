"""The system under test: the port's own sample-block loop, or one
reverse-mode gradient of a rollout.

The only module of the benchmark that imports the program
(``nbody_tpu_torch``).  The traffic file's ``job`` picks the driver
(``make``):

* ``block_loop`` (the default): ``Program`` drives
  ``simulation._DeviceRunner``, as ``simulation._run_prepared`` does:
  ``prepare()`` once (the state from the seed, the P3M plan, the warm
  block), then ``run_block`` and ``check_sr_health`` after each block.  The
  runner is private; the program has no public per-block entry yet.
* ``rollout_grad``: ``RolloutGrad`` takes one gradient of a rollout from
  the set-up state a block, through the program's public path only
  (``make_state``, ``pm.suggest_sr_plan``, ``make_accel_fn``,
  ``make_rollout_fn``, ``torch.autograd.grad``).

Both give the window (``window.py``) the same calls: ``restore``,
``run_block``, ``health``, ``state``, ``sync``.

Spans are the harness's: ``spans(targets)`` wraps the program's functions
that the cell's per-layer metrics name (their ``SPANS``) in
``torch.profiler.record_function`` ranges for a traced run, named
``bench:<label>``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


def sim_config(config: dict, traffic: dict, seed: int, platform=None,
               overrides: dict | None = None):
    """The program's configuration of this cell; ``overrides``: program
    options that replace the configuration's (the control's)."""
    from nbody_tpu_torch.config import SimConfig

    program = dict(config["program"], **(overrides or {}))
    return SimConfig(
        n=int(traffic["n"]),
        nsteps=int(traffic["block_steps"]) * int(traffic["segment_blocks"]),
        dt=float(traffic["dt"]), sfreq=int(traffic["block_steps"]),
        distribution=traffic["distribution"], seed=int(seed),
        platform=platform, **program)


class Program:
    """One cell's runner, prepared, with a device copy of its initial
    state that each segment starts from."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 platform=None, overrides: dict | None = None):
        from nbody_tpu_torch.simulation import _DeviceRunner

        self.cfg = sim_config(config, traffic, seed, platform, overrides)
        self.block_steps = self.cfg.sfreq
        self.runner = _DeviceRunner(self.cfg)
        self.runner.prepare()
        self.initial = self.runner.state
        self.n = self.initial.n
        self.device = self.runner.device
        # Warm what the window runs besides the block.
        self.restore()
        self.health()
        self.sync()

    def restore(self) -> None:
        """Start a segment: the state as set-up left it, in fresh tensors."""
        s = self.initial
        self.runner.state = dataclasses.replace(
            s, pos=s.pos.clone(), vel=s.vel.clone())

    def run_block(self) -> float:
        """One sample block; returns the kinetic energy the host reads."""
        return self.runner.run_block(self.block_steps)

    def health(self) -> None:
        self.runner.check_sr_health()

    def state(self) -> tuple:
        """(pos, vel) of the current state, the program's own tensors."""
        return self.runner.state.pos, self.runner.state.vel

    def host(self, seg: dict) -> dict:
        """Kept states on the host in float64, real particles."""
        n = self.n
        return {k: (p[:, :n].double().cpu(), v[:, :n].double().cpu())
                for k, (p, v) in seg.items()}

    def stretch_states(self) -> tuple:
        """(pos, mass) of the traced stretch's first and last states."""
        n, last = self.n, self.runner.state
        return ((self.initial.pos[:, :n], self.initial.mass[:n]),
                (last.pos[:, :n], last.mass[:n]))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_name(self) -> str:
        return self.runner.device_name()

    def close(self) -> None:
        self.runner.finish()
        self.runner = None
        self.initial = None

    @contextlib.contextmanager
    def spans(self, targets: dict):
        """Profiler ranges ``bench:<label>`` around the program's functions
        for a traced run.  ``targets``: label -> ``"module:function"`` (a
        module's function, replaced while the context is open) or
        ``"runner:attribute"`` (a function the runner holds, such as the
        force function its blocks are built around; the blocks are rebuilt
        around the ranged one)."""
        import importlib

        runner = self.runner
        blocks = dict(runner._blocks)
        with _wrapped(targets, lambda where: runner if where == "runner"
                      else importlib.import_module(where)):
            runner._blocks.clear()
            try:
                yield
            finally:
                runner._blocks.clear()
                runner._blocks.update(blocks)


class RolloutGrad:
    """One reverse-mode gradient of a rollout a block, always from the
    set-up state, as a user fitting initial conditions takes it: the
    state from the seed, the plan for a differentiable call
    (``suggest_sr_plan(..., differentiable=True)``: its worklist has no
    paired rows) at the configuration's capacity, the differentiable force
    (``make_accel_fn(kernel, differentiable=True, ...)``), a rollout of
    ``block_steps`` steps with the program's default rematerialisation,
    then ``torch.autograd.grad`` of the traffic's loss with respect to the
    initial positions and velocities, inside the range ``bench:backward``.

    The loss, L = sum_i |x_i(K) - c_i|^2 over the real bodies with
    c = x(0) + K dt v(0) from the set-up state (a constant), is the squared
    displacement that gravity adds to free drift; it is summed in float64
    from the program's float32 positions.  The block ends in one host read
    of it, after the backward."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 platform=None, overrides: dict | None = None):
        from nbody_tpu_torch.init import make_state
        from nbody_tpu_torch.models.gravity import make_accel_fn
        from nbody_tpu_torch.models.rollout import make_rollout_fn
        from nbody_tpu_torch.ops import pm

        cfg = self.cfg = sim_config(config, traffic, seed, platform,
                                    overrides)
        self.block_steps = cfg.sfreq
        self.device = cfg.device()
        state = make_state(cfg.n, pad_multiple=cfg.pad_multiple(),
                           distribution=cfg.distribution, seed=cfg.seed,
                           device=self.device)
        self.n = state.n
        self.pos0, self.vel0, self.mass = state.pos, state.vel, state.mass
        if cfg.resolved_kernel() == "p3m":
            plan = pm.suggest_sr_plan(state.pos, state.mass,
                                      *cfg.mesh_params(),
                                      capacity=cfg.pm_capacity,
                                      differentiable=True)
            cfg.pm_capacity = plan["capacity"]
            cfg.pm_sr_slabs = plan["sr_slabs"]
            cfg.pm_sr_entries = plan["sr_entries"]
        accel = make_accel_fn(cfg.kernel, differentiable=True,
                              **cfg.kernel_opts())
        self.rollout = make_rollout_fn(self._recorded(accel), cfg.dt,
                                       self.block_steps, cfg.integrator)
        # The program steps by dt in float32.
        drift = self.block_steps * float(np.float32(cfg.dt))
        n = self.n
        self.target = (self.pos0[:, :n].double()
                       + drift * self.vel0[:, :n].double())
        self._seen, self._out = [], None
        # Warm what the window runs: one whole gradient.
        self.run_block()
        self.sync()

    def _recorded(self, accel):
        """The force function, noting the positions of a gradient's first
        ``block_steps`` calls (its forward; rematerialisation calls again
        with the same states)."""
        def force(pos, mass, **kw):
            if len(self._seen) < self.block_steps:
                self._seen.append(pos.detach())
            return accel(pos, mass, **kw)
        return force

    def restore(self) -> None:
        """Nothing to restore: every gradient starts from the set-up state
        and leaves it as it was."""

    def run_block(self) -> float:
        """One gradient; returns the loss the host reads after it."""
        self._seen = []
        x0 = self.pos0.detach().requires_grad_(True)
        v0 = self.vel0.detach().requires_grad_(True)
        xk, _ = self.rollout(x0, v0, self.mass)
        d = xk[:, :self.n].double() - self.target
        loss = (d * d).sum()
        with torch.profiler.record_function("bench:backward"):
            grads = torch.autograd.grad(loss, (x0, v0), allow_unused=True)
        # A rollout that never used an input gives it no gradient: zeros,
        # which the check then reads as wrong.
        gx, gv = (torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads, (x0, v0)))
        self._out = (xk.detach(), gx, gv, self._seen)
        return float(loss.detach())

    def health(self) -> None:
        """Nothing in the window: whether any body overflowed its cell, or
        any worklist entry was dropped, in any step of a gradient is read
        from the kept gradients after the window (``host``)."""

    def state(self) -> tuple:
        """(x(K), gx, gv, the states the force saw) of the last gradient,
        the program's own tensors."""
        return self._out

    def overflow(self, states) -> float:
        """The largest share of bodies past their cell's capacity, or count
        of worklist entries dropped, over ``states``: 0 where the plan
        bins every body and runs every entry."""
        from nbody_tpu_torch.ops import pm

        cfg = self.cfg
        grid, cutoff = cfg.mesh_params()
        worst = 0.0
        for pos in states:
            frac = float(pm.cell_overflow_fraction(
                pos, self.mass, grid, cutoff, cfg.pm_capacity))
            dropped = pm.sr_entry_overflow(
                pos, self.mass, grid, cutoff, capacity=cfg.pm_capacity,
                sr_slabs=cfg.pm_sr_slabs, sr_entries=cfg.pm_sr_entries,
                differentiable=True)
            worst = max(worst, frac, float(dropped))
        return worst

    def host(self, seg: dict) -> dict:
        """Kept gradients on the host in float64, real particles, each with
        its overflow reading."""
        n = self.n
        return {k: dict(x=x[:, :n].double().cpu(), gx=gx[:, :n].double()
                        .cpu(), gv=gv[:, :n].double().cpu(),
                        overflow=self.overflow(seen))
                for k, (x, gx, gv, seen) in seg.items()}

    def stretch_states(self) -> tuple:
        """(pos, mass) of the first and last states the force saw in the
        traced stretch's last gradient."""
        n, seen = self.n, self._out[3]
        return ((seen[0][:, :n], self.mass[:n]),
                (seen[-1][:, :n], self.mass[:n]))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def close(self) -> None:
        self.rollout = self._out = None
        self._seen = []

    def spans(self, targets: dict):
        """Profiler ranges ``bench:<label>`` around the program's module
        functions (``"module:function"``) for a traced run."""
        import importlib

        return _wrapped(targets, importlib.import_module)


JOBS = {"block_loop": Program, "rollout_grad": RolloutGrad}


def make(config: dict, traffic: dict, seed: int, platform=None,
         overrides: dict | None = None):
    """The driver of the traffic's ``job``, set up."""
    return JOBS[traffic.get("job", "block_loop")](
        config, traffic, seed, platform=platform, overrides=overrides)


@contextlib.contextmanager
def _wrapped(targets: dict, owner_of):
    """Each ``"where:attr"`` target of ``targets`` replaced by its ranged
    version on ``owner_of(where)`` while the context is open."""
    saved = []
    try:
        for label, target in targets.items():
            where, attr = target.split(":")
            owner = owner_of(where)
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, ranged(label, saved[-1][2]))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def ranged(label: str, fn):
    name = "bench:" + label

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call
