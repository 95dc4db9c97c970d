"""The port's fused sample block on the CPU, against the JAX package's.

On the CPU ``fused_block`` runs its plain PyTorch version (the CUDA kernels
cannot run here), so these tests hold it against JAX
``fused_block(interpret=True)`` in both layouts and both integrators, and
run the fused path end to end through ``run`` and the CLI against the
golden traces.  Inputs are made by numpy from a seed and fed to both
packages.  The kernels themselves are held against the plain version on a
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the port sums in another order than the Pallas kernels (and the
rows blocks differ: 128 here, 256 in JAX at N=256), so they agree to fp32
summation error: pos rtol 1e-5 / atol 1e-7, vel rtol 1e-5 / atol 1e-9,
kinetic energy rel 1e-6.

The engine's fused path (``_DeviceRunner`` under ``SimConfig(fused=True)``,
what ``--fused`` and the benchmark's cell ``direct-n16384-fused`` run) is
also held against the benchmark's float64 direct reference
(``bench_torch/references/direct.py`` through ``harness/reference.follow``),
with the tolerances of ``REF_TOL``, which the unfused bf16 distance mode
fails.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models.gravity import make_fused_block_fn as jax_fused_block_fn
from nbody_tpu.ops.fused_block import fused_block as jax_fused_block
from nbody_tpu.state import ParticleState as JaxState
from nbody_tpu_torch import SimConfig, run
from nbody_tpu_torch.models.gravity import make_block_fn, make_fused_block_fn
from nbody_tpu_torch.ops import fused_block, sym_kernel, tiled_kernel
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.utils.reporting import parse_trace

from nbody_tpu_torch.simulation import _DeviceRunner

from .util import parse_golden_trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch")
sys.path.insert(0, BENCH)

from harness import ics, reference  # noqa: E402


def _seeded_state(n, seed):
    """One state made by numpy from a seed, as (JAX state, port state)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    jst = JaxState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), n=n)
    return jst, from_numpy(pos, vel, mass, n, device="cpu")


# (steps, tiling and integrator, layout the port must take)
CASES = [
    (10, dict(), "rows"),
    (8, dict(integrator="leapfrog"), "rows"),
    (10, dict(tile_i=128, tile_j=256), "columns"),
    (6, dict(tile_j=64), "columns"),  # a lone tile_j needs the columns
]


@pytest.mark.parametrize("steps,kw,want", CASES,
                         ids=["rows-euler", "rows-leapfrog", "columns",
                              "tile_j-only"])
def test_fused_block_matches_jax(steps, kw, want):
    jst, st = _seeded_state(256, 11)
    rows, _, _ = fused_block.layout(256, kw.get("tile_i", 0),
                                    kw.get("tile_j", 0))
    assert ("rows" if rows else "columns") == want
    j_pos, j_vel = jax_fused_block(jst.pos, jst.vel, jst.mass, 0.1, steps,
                                   interpret=True, **kw)
    before = fused_block.launches
    new, ke = make_fused_block_fn(0.1, steps, **kw)(st)
    assert fused_block.launches == before  # the CPU runs the plain version
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(j_pos),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(new.vel.numpy(), np.asarray(j_vel),
                               rtol=1e-5, atol=1e-9)
    j_ke = jax_fused_block_fn(0.1, steps, interpret=True, **kw)(jst)[1]
    assert ke.dim() == 0 and ke.dtype == torch.float32
    assert float(ke) == pytest.approx(float(j_ke), rel=1e-6)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("tiles", [(0, 0), (64, 128)], ids=["rows", "columns"])
def test_fused_plain_is_the_unfused_block(integrator, tiles):
    """The plain fused block runs the unfused block's steps over the same
    plain sweep, so the two are equal bit for bit; the fused block fn
    leaves its input state untouched (the warm-up relies on it)."""
    _, st = _seeded_state(256, 12)
    pos0, vel0 = st.pos.clone(), st.vel.clone()
    got, ke = make_fused_block_fn(0.1, 5, *tiles, integrator=integrator)(st)
    if tiles == (0, 0):
        def accel(p, m):
            return sym_kernel.accelerations_plain(p, m, 128)
    else:
        def accel(p, m):
            return tiled_kernel.accelerations_between_plain(p, p, m)
    want, want_ke = make_block_fn(accel, 0.1, 5, integrator=integrator)(st)
    assert torch.equal(got.pos, want.pos) and torch.equal(got.vel, want.vel)
    assert float(ke) == float(want_ke)
    assert torch.equal(st.pos, pos0) and torch.equal(st.vel, vel0)


def test_fused_zero_steps_and_padding():
    _, st = _seeded_state(200, 13)
    pos, vel = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 0,
                                       integrator="leapfrog")
    assert torch.equal(pos, st.pos) and torch.equal(vel, st.vel)
    # Zero-mass padding stays exactly at rest.
    from nbody_tpu_torch.state import pad_state

    pad = pad_state(st.pos.numpy(), st.vel.numpy(), st.mass.numpy(), 256,
                    device="cpu")
    pos, vel = fused_block.fused_block(pad.pos, pad.vel, pad.mass, 0.1, 4)
    assert torch.all(vel[:, 200:] == 0.0)
    assert torch.equal(pos[:, 200:], pad.pos[:, 200:])


@pytest.mark.parametrize("tiles", [(0, 0), (64, 128)], ids=["rows", "columns"])
def test_fused_golden_trace(golden_dir, tiles):
    golden = parse_golden_trace(os.path.join(golden_dir, "ver0_n256_s100.txt"))
    res = run(SimConfig(n=256, nsteps=100, fused=True, tile_i=tiles[0],
                        tile_j=tiles[1], platform="cpu"), quiet=True)
    assert res.device == "cpu"
    assert [(s, f"{ke:.5g}") for s, ke in res.kenergy_trace] == golden


@pytest.mark.parametrize("kw,match", [
    (dict(tile_i=96), "divisible by block"),
    (dict(tile_i=128, tile_j=96), r"divisible by tiles \(128,96\)"),
    (dict(tile_j=96), r"divisible by tiles \(64,96\)"),
    (dict(integrator="verlet"), "unknown integrator"),
])
def test_fused_tiling_errors(kw, match):
    _, st = _seeded_state(256, 14)
    with pytest.raises(ValueError, match=match):
        fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 1, **kw)


@pytest.mark.parametrize("kw,pad", [
    (dict(), 128),  # rows: the block, whatever the kernel
    (dict(kernel="naive"), 128),
    (dict(kernel="pallas", tile_i=256), 256),
    (dict(tile_i=64, tile_j=256), 256),  # columns: lcm of the tiles
    (dict(tile_j=96), 192),
])
def test_fused_config_padding(kw, pad):
    cfg = SimConfig(n=2000, fused=True, platform="cpu", **kw)
    assert cfg.pad_multiple() == pad
    assert SimConfig(n=2000, kernel="naive", platform="cpu").pad_multiple() == 1


def test_fused_config_requires_f32():
    with pytest.raises(ValueError, match="f32"):
        SimConfig(fused=True, precision="bf16")


def test_fused_cli_subprocess_golden(golden_dir):
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "128", "50", "--fused",
         "--platform", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert parse_trace(proc.stdout) == parse_golden_trace(
        os.path.join(golden_dir, "ver0_n128_s50.txt"))


# The fused block runs the exact open-boundary sweep alone: every option of
# the mesh tier is refused with it (the JAX package runs the exact block and
# drops them without a word).
@pytest.mark.parametrize("kw", [
    dict(kernel="pm"),
    dict(kernel="p3m"),
    dict(kernel="pm", pm_boundary="periodic", pm_box=1.0),
    dict(kernel="p3m", pm_boundary="periodic", pm_box=1.0),
    dict(pm_sr_layout="pallas"),
    dict(pm_replan=True),
    dict(pm_cutoff=4),
], ids=["pm", "p3m", "pm-periodic", "p3m-periodic", "sr-layout", "replan",
        "cutoff"])
def test_fused_refuses_the_mesh_tier(kw):
    with pytest.raises(ValueError, match="--fused runs the exact"):
        SimConfig(n=256, fused=True, platform="cpu", **kw)
    SimConfig(n=256, platform="cpu", **dict(kw, kernel=kw.get("kernel", "p3m")))


def test_fused_cli_refuses_p3m():
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "128", "10", "--fused",
         "--kernel", "p3m", "--platform", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "--fused runs the exact" in proc.stderr and "--kernel p3m" in proc.stderr
    assert not proc.stdout.strip()


# The fused engine against the float64 direct reference: N=256, two blocks
# of 10 steps at dt 0.1 from the upstream's cube.  ke: the widest relative
# gap of a block's kinetic energy, float32 sums of 256 terms on float32
# velocities (readings 4.3e-8 to 8.3e-8).  dv: the relative L2 gap of the
# velocity change over the run, which is small against the velocities
# themselves, so float32's rounding of v each step is ~1e-5 of it
# (readings 9.8e-6 to 1.4e-5).  x: the relative L2 gap of the positions
# against the distance moved, float32's rounding of positions near 0.5
# against short moves (readings 4.3e-5 to 5.4e-5).  The unfused bf16
# distance mode rounds each pair delta to 8 bits of mantissa, which puts
# 3.7e-4 to 4.1e-4 into dv.
REF_TOL = {"ke": 1e-6, "dv": 5e-5, "x": 2e-4}


def _gaps_to_reference(seed: int, **kw) -> dict:
    """The engine's two blocks against the reference's, as REF_TOL reads
    them."""
    n, steps = 256, 10
    runner = _DeviceRunner(SimConfig(n=n, nsteps=2 * steps, sfreq=steps,
                                     seed=seed, platform="cpu", **kw))
    runner.prepare()
    x0 = runner.state.pos[:, :n].double()
    v0 = runner.state.vel[:, :n].double()
    kes = [runner.run_block(steps) for _ in range(2)]
    pos, vel, mass = (torch.from_numpy(a) for a in ics.make("reference", n,
                                                            seed))
    assert torch.equal(pos.double(), x0) and torch.equal(vel.double(), v0)
    config = {"solver": "direct", "G": reference.G_NEWTON,
              "softening_squared": reference.SOFTENING_SQUARED}
    ref = reference.follow(pos, vel, mass, config, 0.1, steps, 2)
    x_ref, v_ref = ref[-1][1], ref[-1][2]
    x, v = runner.state.pos[:, :n].double(), runner.state.vel[:, :n].double()

    def rel(a, b, scale):
        return float((a - b).norm() / scale.norm())

    return {"ke": max(abs(k - r[0]) / r[0] for k, r in zip(kes, ref)),
            "dv": rel(v - v0, v_ref - v0, v_ref - v0),
            "x": rel(x, x_ref, x_ref - x0)}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_fused_engine_meets_the_float64_reference(seed):
    got = _gaps_to_reference(seed, fused=True)
    assert all(got[k] <= tol for k, tol in REF_TOL.items()), got


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_bf16_distance_mode_fails_the_reference_tolerance(seed):
    """The fused cell's control: the unfused bf16 distance mode, outside
    the velocity change's tolerance by more than 4x."""
    got = _gaps_to_reference(seed, precision="bf16")
    assert got["dv"] > 4 * REF_TOL["dv"], got


def test_direct_reference_imports_no_jax():
    """The reference the tests and the cell use loads neither JAX, the JAX
    package nor the program."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from harness import reference; reference.solver('direct'); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', "
            "'jaxlib', 'nbody_tpu', 'nbody_tpu_torch'}))")
    proc = subprocess.run([sys.executable, "-c", code, BENCH], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
