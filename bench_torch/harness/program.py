"""The system under test: the port's own sample-block loop.

The only module of the benchmark that imports the program
(``nbody_tpu_torch``).  It drives ``simulation._DeviceRunner``, as
``simulation._run_prepared`` does: ``prepare()`` once (the state from the
seed, the P3M plan, the warm block), then ``run_block`` and
``check_sr_health`` after each block.  The runner is private; the program
has no public per-block entry yet.

Spans are the harness's: ``spans(targets)`` wraps the program's functions
that the cell's per-layer metrics name (their ``SPANS``) in
``torch.profiler.record_function`` ranges for a traced run, named
``bench:<label>``.
"""

from __future__ import annotations

import contextlib
import dataclasses

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
        saved = []
        for label, target in targets.items():
            where, attr = target.split(":")
            owner = runner if where == "runner" else importlib.import_module(
                where)
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, ranged(label, saved[-1][2]))
        runner._blocks.clear()
        try:
            yield
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)
            runner._blocks.clear()
            runner._blocks.update(blocks)


def ranged(label: str, fn):
    name = "bench:" + label

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call
