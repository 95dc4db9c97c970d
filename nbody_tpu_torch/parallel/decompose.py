"""The particle decomposition, the counterpart of
``nbody_tpu/parallel/decompose.py`` (the reference's MPI layer,
ver5_all/GSimulation.cpp:93-214).

The state is sharded over the particle axis into K equal contiguous blocks
(zero-mass padding makes them equal) and stays sharded.  The JAX package
runs a block under ``shard_map``: one program per shard, with the
collectives between them.  The port keeps its single controller: one
process holds all K shards (``ShardedState``) and runs each step's comm mode
over the list of shards, with the collectives written out as functions
(``all_gather``, ``ppermute``, ``psum``) that move tensors with
``.to(device)``.  On one card the shards are virtual (``mesh.py``) and the
collectives move no bytes over a link.

The four exact comm modes:

* ``allgather`` -- each shard gathers every position and mass and sweeps
  its own targets against all of them (the between form of the kernel);
* ``ring``      -- the source blocks pass round the ring in K - 1 hops, each
  shard sweeping the block in hand;
* ``ring_sym``  -- the half ring with pair symmetry: each unordered shard
  pair once, by the two-sided kernel, the reactions riding the ring home;
  the diagonal block by the pair-symmetric self-kernel;
* ``rdma``      -- the whole ring in one kernel launch (``ring_kernel.py``).

The kinetic energy is a per-shard sum followed by ``psum`` in shard order.
The sharded mesh solve (``pm``/``p3m``) is not ported yet (ROADMAP.md queue
1 item 11(b)).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models.gravity import kinetic_energy
from ..models.integrators import INTEGRATORS, step_sizes
from ..ops import registry, sym_kernel
from ..state import ParticleState
from .mesh import Mesh, make_mesh
from .ring_kernel import ring_accelerations

COMM_MODES = ("allgather", "ring", "ring_sym", "rdma")


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """K contiguous shards of a padded state, each on its shard's device:
    ``pos`` and ``vel`` K (3, N/K) fp32 tensors, ``mass`` K (N/K,); ``n``
    real particles in all."""

    pos: tuple
    vel: tuple
    mass: tuple
    n: int

    @property
    def n_padded(self) -> int:
        return sum(p.shape[1] for p in self.pos)


def shard_state(state: ParticleState, shards: int,
                mesh: Mesh = None) -> tuple[ShardedState, Mesh]:
    """Place a (padded) state onto a ``shards``-slot mesh, particle-sharded."""
    if mesh is None:
        mesh = make_mesh(shards)
    if state.n_padded % shards:
        raise ValueError(
            f"padded count {state.n_padded} not divisible by {shards} shards"
        )
    nl = state.n_padded // shards

    def split(x):
        return tuple(x[..., s * nl:(s + 1) * nl].to(d).contiguous()
                     for s, d in enumerate(mesh.devices))

    return ShardedState(pos=split(state.pos), vel=split(state.vel),
                        mass=split(state.mass), n=state.n), mesh


def unshard_state(sharded: ShardedState) -> ParticleState:
    """The whole state on the first shard's device."""
    dev = sharded.pos[0].device

    def cat(xs):
        return torch.cat([x.to(dev) for x in xs], dim=-1)

    return ParticleState(pos=cat(sharded.pos), vel=cat(sharded.vel),
                         mass=cat(sharded.mass), n=sharded.n)


# The collectives, over one tensor a shard.


def all_gather(xs: list, mesh: Mesh) -> list:
    """Every shard gets the concatenation of all shards' tensors along the
    last axis (``lax.all_gather(..., tiled=True)``); shards on one device
    share one copy."""
    gathered = {}
    for d in mesh.devices:
        if d not in gathered:
            gathered[d] = torch.cat([x.to(d) for x in xs], dim=-1)
    return [gathered[d] for d in mesh.devices]


def ppermute(xs: list, shift: int, mesh: Mesh) -> list:
    """Shard s receives the tensor of shard s - shift (mod K): ``shift=1``
    is the ring's hop to the right neighbour."""
    k = mesh.size
    return [xs[(s - shift) % k].to(d) for s, d in enumerate(mesh.devices)]


def psum(xs: list, mesh: Mesh) -> list:
    """Every shard gets the sum of all shards' tensors, added in shard
    order."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return [total.to(d) for d in mesh.devices]


# The force modes: K positions and K masses -> K accelerations.


def _accel_allgather(between_fn, pos, mass, mesh):
    pos_all = all_gather(pos, mesh)
    mass_all = all_gather(mass, mesh)
    return [between_fn(p, pa, ma) for p, pa, ma in zip(pos, pos_all, mass_all)]


def _accel_ring(between_fn, pos, mass, mesh):
    """K - 1 hops of the packed (4, N/K) source blocks to the right."""
    buf = [torch.cat([p, m[None, :]]) for p, m in zip(pos, mass)]
    acc = [between_fn(p, b[0:3], b[3]) for p, b in zip(pos, buf)]
    for _ in range(mesh.size - 1):
        buf = ppermute(buf, 1, mesh)
        acc = [a + between_fn(p, b[0:3], b[3])
               for a, p, b in zip(acc, pos, buf)]
    return acc


def _accel_ring_sym(pos, mass, mesh, self_fn, two_sided_fn):
    """The half ring with pair symmetry: each unordered shard pair is
    computed once, by one of its members, with the reaction riding the
    ring buffer back home.

    The diagonal block takes the self-kernel; floor((K - 1) / 2) hops
    stream (positions, masses, reaction) to the right, each evaluating one
    two-sided block pair; for even K one more hop covers the antipodal
    pairs, which both members see: the lower half of the shards computes
    both sides and the upper half's calls, masked to 0 in the JAX package,
    are skipped (the sums are the same); one hop back returns each
    reaction to its home shard."""
    k = mesh.size
    acc = [self_fn(p, m) for p, m in zip(pos, mass)]
    if k == 1:
        return acc
    # (7, N/K): the source block and its travelling reaction.
    buf = [torch.cat([p, m[None, :], torch.zeros_like(p)])
           for p, m in zip(pos, mass)]

    def hop(shards):
        for s in shards:
            a_t, a_s = two_sided_fn(pos[s], mass[s], buf[s][0:3], buf[s][3])
            acc[s] = acc[s] + a_t
            buf[s][4:7] += a_s  # in place: each buffer is one shard's alone

    h_final = (k - 1) // 2
    for _ in range(h_final):
        buf = ppermute(buf, 1, mesh)
        hop(range(k))
    if k % 2 == 0:
        buf = ppermute(buf, 1, mesh)
        hop(range(k // 2))
        h_final += 1
    # The block (and its reactions) sits h_final shards ahead of its owner.
    react = ppermute([b[4:7] for b in buf], -h_final, mesh)
    return [a + r for a, r in zip(acc, react)]


_BETWEEN_MODES = {"allgather": _accel_allgather, "ring": _accel_ring}


def check_sharded_kernel(kernel_name: str, comm: str) -> None:
    """Raise for a kernel the sharded modes do not take: the mesh tiers."""
    if kernel_name not in ("pm", "p3m"):
        return
    if comm != "allgather":
        # The mesh solver needs every target inside the source box; the
        # ring modes stream source blocks whose boxes do not cover remote
        # targets.
        raise ValueError(
            f"--kernel {kernel_name} supports only --comm allgather when "
            "sharded")
    raise NotImplementedError(
        f"--kernel {kernel_name} with --shards > 1 (the sharded mesh solve) "
        "is not ported yet: ROADMAP.md queue 1 item 11(b)")


def check_sharded_dist(comm: str, dist_dtype: str) -> None:
    """Raise for the bf16 distance mode in ``rdma``, whose ring kernel runs
    fp32 only (the JAX package's drops the mode silently, as its
    ``ring_sym`` does); ``allgather`` and ``ring`` pass it to the between
    form, ``ring_sym`` to both pair-symmetric kernels."""
    if comm == "rdma" and dist_dtype != "float32":
        raise ValueError(f"--comm {comm} runs fp32 kernels only; --precision "
                         "bf16 needs --comm allgather, ring or ring_sym")


def _accel_fn(kernel_name: str, kernel_opts: dict, mesh: Mesh, comm: str):
    """The comm mode's force function over the shard lists."""
    check_sharded_kernel(kernel_name, comm)
    check_sharded_dist(comm, kernel_opts.get("dist_dtype", "float32"))
    if comm == "rdma":
        ropts = {key: v for key, v in kernel_opts.items()
                 if key in ("tile_i", "tile_j")}
        return lambda pos, mass: ring_accelerations(pos, mass, **ropts)
    if comm == "ring_sym":
        # The pair-symmetric kernels make the mode: the kernel name sets
        # nothing but the block (tile_i) and the distance mode.
        sym_opts = dict(block=kernel_opts.get("tile_i", 0),
                        dist_dtype=kernel_opts.get("dist_dtype", "float32"))
        self_fn = functools.partial(sym_kernel.accelerations, **sym_opts)
        two_sided_fn = functools.partial(sym_kernel.accelerations_two_sided,
                                         **sym_opts)
        return lambda pos, mass: _accel_ring_sym(pos, mass, mesh, self_fn,
                                                 two_sided_fn)
    if comm not in _BETWEEN_MODES:
        raise ValueError(f"unknown comm mode {comm!r}; options: {COMM_MODES}")
    between_fn = registry.get_between(kernel_name)
    if kernel_opts:
        between_fn = functools.partial(between_fn, **kernel_opts)
    mode = _BETWEEN_MODES[comm]
    return lambda pos, mass: mode(between_fn, pos, mass, mesh)


def make_sharded_block_fn(kernel_name: str, kernel_opts: dict, dt: float,
                          block_steps: int, mesh: Mesh,
                          comm: str = "allgather", integrator: str = "euler"):
    """A sample block over a particle-sharded state: ``run(sharded) ->
    (sharded, kinetic_energy)``, advancing ``block_steps`` steps with no
    host sync; the energy is a 0-d tensor on the first shard's device.  At
    every step all shards' forces are taken from the same positions."""
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    accel = _accel_fn(kernel_name, kernel_opts, mesh, comm)
    dtf, half = step_sizes(dt)

    def run(sharded: ShardedState):
        pos, vel, mass = list(sharded.pos), list(sharded.vel), sharded.mass
        if integrator == "euler":
            for _ in range(block_steps):
                acc = accel(pos, mass)
                vel = [v + a * dtf for v, a in zip(vel, acc)]
                pos = [p + v * dtf for p, v in zip(pos, vel)]
        else:  # leapfrog, kick-drift-kick, the acceleration carried
            acc = accel(pos, mass)
            for _ in range(block_steps):
                vel = [v + a * half for v, a in zip(vel, acc)]
                pos = [p + v * dtf for p, v in zip(pos, vel)]
                acc = accel(pos, mass)
                vel = [v + a * half for v, a in zip(vel, acc)]
        ke = psum([kinetic_energy(ParticleState(p, v, m, 0))
                   for p, v, m in zip(pos, vel, mass)], mesh)[0]
        return ShardedState(pos=tuple(pos), vel=tuple(vel), mass=mass,
                            n=sharded.n), ke

    return run
