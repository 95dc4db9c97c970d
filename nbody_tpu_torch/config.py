"""Run configuration.

The slice of ``nbody_tpu.config.SimConfig`` that the port runs.  Defaults
mirror the reference ctor (ver0/GSimulation.cpp:24-32): N=2000, 500 steps,
dt=0.1, sample frequency 50.  Values the JAX package knows but the port has
not ported yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .models.distributions import DISTRIBUTIONS
from .models.integrators import INTEGRATORS
from .types import PRECISIONS, SUPPORTED_PRECISIONS

KERNELS = ("naive", "pallas", "pallas_sym", "auto")
PLATFORMS = ("cuda", "cpu")

# Known to the JAX package, not ported yet: value -> ROADMAP.md item.
_NOT_PORTED = {
    "bf16": "queue 1 item 4 (the bf16 distance mode)",
    "ref64": "queue 1 item 12 (the ref64 host oracle)",
    "pm": "queue 1 item 7 (the PM tier)",
    "p3m": "queue 1 item 8 (P3M)",
    "pallas_mxu": "queue 1 item 13 (pallas_mxu)",
}


def _check(what: str, value, options) -> None:
    if value in options:
        return
    if value in _NOT_PORTED:
        raise NotImplementedError(
            f"{what} {value!r} is not ported yet: ROADMAP.md {_NOT_PORTED[value]}"
        )
    raise ValueError(f"unknown {what} {value!r}; options: {options}")


@dataclasses.dataclass
class SimConfig:
    n: int = 2000
    nsteps: int = 500
    dt: float = 0.1
    sfreq: int = 50
    integrator: str = "euler"  # euler (reference parity) | leapfrog
    distribution: str = "reference"  # | plummer | cold_sphere
    seed: int = 42  # the reference hard-codes 42 (ver0/GSimulation.cpp:47)
    energy_check: bool = False  # report total-energy (KE+PE) drift at end
    kernel: str = "auto"  # naive | pallas | pallas_sym | auto
    tile_i: int = 0  # 0 = kernel default (pallas_sym: the block size)
    tile_j: int = 0
    precision: str = "f32"
    fused: bool = False  # the whole sample block in one kernel launch
    platform: Optional[str] = None  # None = cuda; "cpu" only on request

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.nsteps < 0:
            raise ValueError(f"nsteps must be >= 0, got {self.nsteps}")
        if self.sfreq < 1:
            raise ValueError(f"sfreq must be >= 1, got {self.sfreq}")
        _check("integrator", self.integrator, INTEGRATORS)
        _check("distribution", self.distribution, tuple(DISTRIBUTIONS))
        _check("kernel", self.kernel, KERNELS)
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; options: {PRECISIONS}"
            )
        if self.fused and self.precision != "f32":
            raise ValueError("--fused requires f32 precision")
        _check("precision", self.precision, SUPPORTED_PRECISIONS)
        if self.platform is not None:
            _check("platform", self.platform, PLATFORMS)

    def device(self) -> torch.device:
        """The device the run uses.  CUDA unless the CPU was asked for; a
        missing card raises instead of falling back to the CPU."""
        if self.platform == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; the CPU path runs only on request "
                "(--platform cpu, SimConfig(platform='cpu') or the 'cpu' "
                "device token)"
            )
        return torch.device("cuda", torch.cuda.current_device())

    def resolved_kernel(self) -> str:
        """``auto`` resolved on the configured platform, before the padded
        N is known (ops/registry.resolve)."""
        from .ops.registry import resolve

        return resolve(self.kernel, self.platform or "cuda")

    def kernel_opts(self) -> dict:
        opts = {}
        if self.resolved_kernel() != "naive":
            if self.tile_i:
                opts["tile_i"] = self.tile_i
            if self.tile_j:
                opts["tile_j"] = self.tile_j
        return opts

    def pad_multiple(self) -> int:
        """Particle-count padding the kernel needs: the pair-symmetric
        kernel sweeps whole blocks (``auto`` on CUDA pads for it, so N=2000
        becomes 2048); the tiled kernel and naive take any N.  Under
        ``fused`` the fused block's layout sets it, whatever ``kernel``
        says: rows blocks, or columns tiles that divide N."""
        from .ops import fused_block
        from .ops.sym_kernel import DEFAULT_BLOCK

        if self.fused:
            return fused_block.pad_multiple(self.tile_i, self.tile_j)
        if self.resolved_kernel() == "pallas_sym":
            return self.tile_i or DEFAULT_BLOCK
        return 1
