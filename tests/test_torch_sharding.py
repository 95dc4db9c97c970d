"""The port's particle decomposition on the CPU, against the JAX package's.

``parallel/decompose.py`` runs the four exact comm modes over K shards that
one process drives (here K CPU slots).  These tests replay the exact modes of
``__graft_entry__.dryrun_multichip`` against JAX's ``make_sharded_block_fn``
on the 8-device CPU mesh of tests/conftest.py: the same numpy-made state,
carried across with ``from_numpy`` and ``shard_state``, in 2-step Euler and
leapfrog blocks, with the JAX ``ring_sym`` and ``rdma`` kernels in interpret
mode as the dryrun runs them.  Then the n256_s100 golden trace through
``run`` in every mode, and the CLI.

Tolerance: the dryrun's own bar (``__graft_entry__.py:100-108``), pos and
vel rtol 2e-6 / atol 1e-10, kinetic energy relative 1e-5: both packages
sum in fp32, in other orders.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.parallel.decompose import make_sharded_block_fn as jax_block_fn
from nbody_tpu.parallel.decompose import shard_state as jax_shard_state
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu.state import ParticleState as JaxState
from nbody_tpu_torch import SimConfig, run
from nbody_tpu_torch.__main__ import main
from nbody_tpu_torch.parallel import make_mesh
from nbody_tpu_torch.parallel.decompose import (
    all_gather,
    make_sharded_block_fn,
    ppermute,
    psum,
    shard_state,
    unshard_state,
)
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.utils.reporting import parse_trace

from .util import parse_golden_trace

torch.set_num_threads(2)

CPU = torch.device("cpu")
DT, STEPS = 0.1, 2
LOCAL = 128  # particles a shard: N = 128 K <= 1024


def _seeded_state(n, seed):
    """One state made by numpy from a seed, as (JAX state, port state)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    jst = JaxState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), n=n)
    return jst, from_numpy(pos, vel, mass, n, device="cpu")


# comm -> (JAX kernel and options, the port's kernel and options), as the
# dryrun pairs them: tile_i 32 and tile_j 64 at 128 particles a shard.
_TILES = dict(tile_i=32, tile_j=64)
MODES = {
    "allgather": (("naive", {}), ("naive", {})),
    "ring": (("pallas", dict(_TILES, interpret=True)), ("pallas", _TILES)),
    "ring_sym": (("pallas_sym", dict(tile_i=32, interpret=True)),
                 ("pallas_sym", dict(tile_i=32))),
    "rdma": (("pallas", dict(_TILES, interpret=True)), ("pallas", _TILES)),
}
CASES = [(comm, k) for comm in ("allgather", "ring") for k in (2, 3, 4, 8)]
CASES += [(comm, k) for comm in ("ring_sym", "rdma") for k in (3, 8)]


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("comm,k", CASES)
def test_sharded_block_matches_jax(comm, k, integrator):
    jst, st = _seeded_state(LOCAL * k, 11 + k)
    (jkern, jopts), (kern, opts) = MODES[comm]
    jsharded, jmesh = jax_shard_state(jst, k, mesh=jax_make_mesh(k))
    j_out, j_ke = jax_block_fn(jkern, jopts, DT, STEPS, jmesh, comm=comm,
                               integrator=integrator)(jsharded)
    sharded, mesh = shard_state(st, k, make_mesh(k, [CPU] * k))
    out, ke = make_sharded_block_fn(kern, opts, DT, STEPS, mesh, comm=comm,
                                    integrator=integrator)(sharded)
    assert len(out.pos) == k and out.pos[0].shape == (3, LOCAL)
    whole = unshard_state(out)
    np.testing.assert_allclose(whole.pos.numpy(), np.asarray(j_out.pos),
                               rtol=2e-6, atol=1e-10)
    np.testing.assert_allclose(whole.vel.numpy(), np.asarray(j_out.vel),
                               rtol=2e-6, atol=1e-10)
    assert abs(float(ke) - float(j_ke)) <= 1e-5 * abs(float(j_ke))
    # the block leaves its input untouched (the engine's warm-up relies on it)
    assert torch.equal(unshard_state(sharded).pos, st.pos)


def test_shard_state_places_and_refuses_uneven():
    _, st = _seeded_state(96, 3)
    sharded, mesh = shard_state(st, 3, make_mesh(3, [CPU] * 3))
    assert mesh.size == 3 and sharded.n_padded == 96 and sharded.n == 96
    assert all(p.is_contiguous() and p.shape == (3, 32) for p in sharded.pos)
    back = unshard_state(sharded)
    for name in ("pos", "vel", "mass"):
        assert torch.equal(getattr(back, name), getattr(st, name))
    with pytest.raises(ValueError, match="not divisible by 5 shards"):
        shard_state(st, 5, make_mesh(5, [CPU] * 5))


def test_collectives():
    mesh = make_mesh(3, [CPU] * 3)
    xs = [torch.full((2,), float(s)) for s in range(3)]
    assert [x.tolist() for x in ppermute(xs, 1, mesh)] == [[2, 2], [0, 0], [1, 1]]
    assert [x.tolist() for x in ppermute(xs, -1, mesh)] == [[1, 1], [2, 2], [0, 0]]
    gathered = all_gather(xs, mesh)
    assert all(g.tolist() == [0, 0, 1, 1, 2, 2] for g in gathered)
    assert [float(t[0]) for t in psum(xs, mesh)] == [3.0, 3.0, 3.0]


def test_mesh():
    assert make_mesh(4, [CPU] * 4).devices == (CPU,) * 4
    with pytest.raises(ValueError, match="requested 5 devices, only 4"):
        make_mesh(5, [CPU] * 4)
    if torch.cuda.is_available():  # the default: slots on the current card
        assert make_mesh(2).devices[0].type == "cuda"
    else:  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(2)


def test_mesh_kernels_refused_when_sharded():
    mesh = make_mesh(2, [CPU] * 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        make_sharded_block_fn("pm", {}, DT, STEPS, mesh)
    with pytest.raises(ValueError, match="only --comm allgather"):
        make_sharded_block_fn("p3m", {}, DT, STEPS, mesh, comm="rdma")
    with pytest.raises(ValueError, match="unknown comm mode"):
        make_sharded_block_fn("naive", {}, DT, STEPS, mesh, comm="mpi")


@pytest.mark.parametrize("comm", ["allgather", "ring", "ring_sym", "rdma"])
def test_golden_trace_sharded(golden_dir, comm):
    golden = parse_golden_trace(f"{golden_dir}/ver0_n256_s100.txt")
    res = run(SimConfig(n=256, nsteps=100, shards=4, comm=comm,
                        platform="cpu"), quiet=True)
    assert res.device == "cpu" and res.nthreads == 4
    assert [(s, f"{ke:.5g}") for s, ke in res.kenergy_trace] == golden


def test_cli_sharded(golden_dir, capsys):
    assert main(["256", "100", "--shards", "4", "--comm", "ring_sym",
                 "--platform", "cpu", "--energy-check"]) == 0
    text = capsys.readouterr().out
    assert parse_trace(text) == parse_golden_trace(
        f"{golden_dir}/ver0_n256_s100.txt")
    assert "# Number Threads     : 4" in text
    assert "# Energy drift |dE/E|: " in text


def test_config_pads_for_the_shards():
    # ring_sym runs the pair-symmetric kernels on every shard: block x K
    # (N=2000, K=3 -> 2304); the others pad as their kernel does, times K.
    assert SimConfig(shards=3, comm="ring_sym").pad_multiple() == 384
    assert SimConfig(shards=3, comm="ring_sym", platform="cpu",
                     tile_i=64).pad_multiple() == 192
    assert SimConfig(shards=4, platform="cpu").pad_multiple() == 4
    assert SimConfig(shards=4, kernel="pallas").pad_multiple() == 4
    assert SimConfig(shards=4).pad_multiple() == 512
    # the comm mode's own kernels take the tiles whatever `kernel` says
    assert SimConfig(shards=2, comm="rdma", tile_i=32, platform="cpu"
                     ).kernel_opts() == {"tile_i": 32}
    assert SimConfig(shards=2, comm="ring", tile_i=32, platform="cpu"
                     ).kernel_opts() == {}
    buf = io.StringIO()
    run(SimConfig(n=64, nsteps=50, shards=3, comm="ring", platform="cpu"),
        out=buf)
    assert "# Number Threads     : 3" in buf.getvalue()
