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
from .parallel.decompose import (
    COMM_MODES,
    check_sharded_dist,
    check_sharded_kernel,
)
from .state import device_or_card
from .types import PRECISIONS, SUPPORTED_PRECISIONS

KERNELS = ("naive", "pallas", "pallas_sym", "pallas_mxu", "pm", "p3m", "auto")
PLATFORMS = ("cuda", "cpu")

# Known to the JAX package, not ported yet: value -> ROADMAP.md item.
_NOT_PORTED = {
    "ref64": "queue 1 item 12 (the ref64 host oracle)",
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
    kernel: str = "auto"  # one of KERNELS (ops/registry.py)
    tile_i: int = 0  # 0 = kernel default (pallas_sym: the block size)
    tile_j: int = 0
    pm_grid: int = 0  # mesh points per axis (0 = ops/pm.DEFAULT_GRID)
    pm_cutoff: int = 0  # P3M split radius in grid spacings (0 = off for
    # pm, ops/pm.DEFAULT_CUTOFF_CELLS for p3m)
    pm_capacity: int = 0  # P3M slots per cell (0 = measured at prepare
    # time by pm.suggest_sr_plan)
    pm_sr_slabs: int = 0  # P3M table slabs (0 = measured, as above)
    pm_sr_entries: int = 0  # P3M worklist entries (0 = measured)
    pm_sr_ghosts: int = 0  # periodic-P3M ghost-image slots (0 = measured)
    pm_boundary: str = "open"  # open | periodic (a fixed cubic box)
    pm_box: float = 0.0  # the periodic box edge L (periodic only)
    pm_sr_layout: str = ""  # P3M sweep layout (ops/pm.SR_LAYOUTS); "" =
    # the module default
    pm_replan: bool = False  # re-measure the P3M plan when the per-block
    # health check finds overflow (grow-only); off = warn once
    precision: str = "f32"  # f32 | bf16 (the bf16 distance mode)
    fused: bool = False  # the whole sample block in one kernel launch
    # The particle decomposition: K shards of one card (virtual shards) or
    # of the CPU, driven by one process (parallel/decompose.py).
    shards: int = 1
    comm: str = "allgather"  # allgather | ring | ring_sym | rdma
    platform: Optional[str] = None  # None = cuda; "cpu" only on request
    profile_dir: Optional[str] = None  # a torch.profiler trace of the blocks
    debug_nans: bool = False  # raise on a non-finite state after each block

    def __post_init__(self):
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.nsteps < 0:
            raise ValueError(f"nsteps must be >= 0, got {self.nsteps}")
        if self.sfreq < 1:
            raise ValueError(f"sfreq must be >= 1, got {self.sfreq}")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.fused and self.shards > 1:
            raise ValueError(
                "--fused runs the whole block in one kernel over the whole "
                "state; it cannot be combined with --shards > 1")
        _check("comm", self.comm, COMM_MODES)
        _check("integrator", self.integrator, INTEGRATORS)
        _check("distribution", self.distribution, tuple(DISTRIBUTIONS))
        _check("kernel", self.kernel, KERNELS)
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"unknown precision {self.precision!r}; options: {PRECISIONS}"
            )
        if self.fused and self.precision != "f32":
            raise ValueError("--fused requires f32 precision")
        if self.fused:
            self._check_fused_exact()
        _check("precision", self.precision, SUPPORTED_PRECISIONS)
        if self.precision == "bf16":
            self._check_bf16()
        if self.platform is not None:
            _check("platform", self.platform, PLATFORMS)
        _check("pm boundary", self.pm_boundary, ("open", "periodic"))
        if self.pm_boundary == "periodic":
            if self.kernel not in ("pm", "p3m"):
                raise ValueError(
                    "--pm-boundary periodic is a mesh-solver mode; it "
                    "requires --kernel pm or p3m")
            if self.pm_box <= 0:
                raise ValueError(
                    "--pm-boundary periodic requires --pm-box L > 0 (the "
                    "fixed cubic box edge)")
        elif self.pm_box:
            raise ValueError("--pm-box only applies to --pm-boundary "
                             "periodic")
        short_range = self.kernel == "p3m" or (self.kernel == "pm"
                                               and self.pm_cutoff)
        if self.pm_sr_layout:
            from .ops.pm import SR_LAYOUTS

            if self.pm_sr_layout not in SR_LAYOUTS:
                raise ValueError(
                    f"unknown --pm-sr-layout {self.pm_sr_layout!r}; "
                    f"options: {tuple(SR_LAYOUTS)}")
            if not short_range:
                raise ValueError(
                    "--pm-sr-layout selects the P3M short-range sweep "
                    "layout; it requires --kernel p3m (or --kernel pm with "
                    "--pm-cutoff > 0)")
        if self.shards > 1:
            check_sharded_kernel(self.kernel, self.comm)
        if self.pm_replan and not short_range:
            raise ValueError(
                "--pm-replan re-measures the P3M short-range plan; it "
                "requires --kernel p3m (or --kernel pm with --pm-cutoff > 0)")

    def _check_fused_exact(self) -> None:
        """Refuse ``fused`` with any option of the mesh tier: the fused
        block runs the exact open-boundary sweep and nothing else, so the
        engine would drop the mesh and the box without a word.  The JAX
        package does that (its config has no such check); the port refuses."""
        mesh = [name for name, on in (
            (f"--kernel {self.kernel}", self.kernel in ("pm", "p3m")),
            ("--pm-boundary periodic", self.pm_boundary == "periodic"),
            ("--pm-sr-layout", bool(self.pm_sr_layout)),
            ("--pm-replan", self.pm_replan),
            ("--pm-cutoff", bool(self.pm_cutoff))) if on]
        if mesh:
            raise ValueError(
                f"--fused runs the exact open-boundary sweep; it cannot run "
                f"the mesh tier ({', '.join(mesh)}): drop --fused to run pm "
                "or p3m")

    def _check_bf16(self) -> None:
        """Refuse the bf16 distance mode where no kernel of the run takes
        it, as the JAX package does for the mesh tiers and pallas_mxu, and
        in the sharded rdma, which the JAX package runs in f32 instead."""
        if self.kernel in ("pm", "p3m"):
            raise ValueError(
                f"--kernel {self.kernel} is fp32-only; it does not support "
                "--precision bf16 (use --kernel pallas for the bf16 "
                "distance mode)")
        if self.kernel == "pallas_mxu":
            from .ops.mxu_kernel import check_fp32_distances

            check_fp32_distances("bfloat16")
        if self.shards > 1:
            check_sharded_dist(self.comm, "bfloat16")

    def device(self) -> torch.device:
        """The device the run uses.  CUDA unless the CPU was asked for; a
        missing card raises instead of falling back to the CPU."""
        return device_or_card("cpu" if self.platform == "cpu" else None)

    def resolved_kernel(self) -> str:
        """``auto`` resolved on the configured platform, before the padded
        N is known (ops/registry.resolve)."""
        from .ops.registry import resolve

        return resolve(self.kernel, self.platform or "cuda")

    def mesh_params(self) -> tuple:
        """(grid, cutoff_cells) of the mesh tiers, with ops/pm's defaults
        where unset: p3m always has a cutoff, pm only when pm_cutoff is
        set."""
        from .ops.pm import DEFAULT_CUTOFF_CELLS, DEFAULT_GRID

        grid = self.pm_grid or DEFAULT_GRID
        if self.resolved_kernel() == "p3m":
            return grid, self.pm_cutoff or DEFAULT_CUTOFF_CELLS
        return grid, self.pm_cutoff

    def resolve_sr_plan(self, pos, mass) -> bool:
        """Fill the P3M static plan (capacity, slabs, entries and, periodic,
        ghost slots) from the concrete state through pm.suggest_sr_plan,
        unless every field that applies is pinned.  Returns whether this
        config has a short-range pass."""
        resolved = self.resolved_kernel()
        if not (resolved == "p3m" or (resolved == "pm" and self.pm_cutoff)):
            return False
        periodic = self.pm_boundary == "periodic"
        if (self.pm_capacity and self.pm_sr_slabs and self.pm_sr_entries
                and (self.pm_sr_ghosts or not periodic)):
            return True
        from .ops.pm import suggest_sr_plan

        plan = suggest_sr_plan(pos, mass, *self.mesh_params(),
                               capacity=self.pm_capacity,
                               boundary=self.pm_boundary, box_size=self.pm_box)
        self.pm_capacity = plan["capacity"]
        self.pm_sr_slabs = self.pm_sr_slabs or plan["sr_slabs"]
        self.pm_sr_entries = self.pm_sr_entries or plan["sr_entries"]
        if periodic:
            self.pm_sr_ghosts = self.pm_sr_ghosts or plan["sr_ghosts"]
        return True

    def kernel_opts(self) -> dict:
        opts = {}
        resolved = self.resolved_kernel()
        # ring_sym and rdma run their own pair kernels (the pair-symmetric
        # ones; the ring), whatever `kernel` resolves to: they take the tiles.
        own_pairs = self.shards > 1 and self.comm in ("ring_sym", "rdma")
        if resolved in ("pallas", "pallas_sym", "pallas_mxu") or own_pairs:
            if self.tile_i:
                opts["tile_i"] = self.tile_i
            if self.tile_j:
                opts["tile_j"] = self.tile_j
        if resolved in ("pm", "p3m"):
            for key, value in (("grid", self.pm_grid),
                               ("cutoff_cells", self.pm_cutoff),
                               ("capacity", self.pm_capacity),
                               ("sr_slabs", self.pm_sr_slabs),
                               ("sr_entries", self.pm_sr_entries),
                               ("sr_ghosts", self.pm_sr_ghosts)):
                if value:
                    opts[key] = value
            if self.pm_boundary != "open":
                opts["boundary"] = self.pm_boundary
                opts["box_size"] = self.pm_box
        if self.precision == "bf16":
            opts["dist_dtype"] = "bfloat16"
        return opts

    def pad_multiple(self) -> int:
        """Particle-count padding the kernel needs, times ``shards``: the
        pair-symmetric kernel sweeps whole blocks (``auto`` on CUDA pads for
        it, so N=2000 becomes 2048), and so do ``ring_sym``'s kernels on
        every shard; the tiled kernel, the mxu kernel (which, unlike the JAX
        package's, masks its ragged tiles), the ring and naive take any N.
        Under ``fused`` the fused block's layout sets it, whatever
        ``kernel`` says: rows blocks, or columns tiles that divide N."""
        from .ops import fused_block
        from .ops.sym_kernel import DEFAULT_BLOCK

        if self.fused:
            return fused_block.pad_multiple(self.tile_i, self.tile_j)
        sym = self.resolved_kernel() == "pallas_sym" or (
            self.shards > 1 and self.comm == "ring_sym")
        return (self.tile_i or DEFAULT_BLOCK if sym else 1) * self.shards
