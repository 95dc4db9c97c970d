"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch (the repository's conftest imports JAX, so
there it is skipped with ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: the kernels sum in other orders than the plain versions, so
they agree to fp32 summation error, bounded at 1e-5 relative norm; the
force VJP at 2e-5, the JAX package's bound between its VJP kernel and its
plain sweep (tests/test_grad.py); the P3M short-range sweep at 2e-5 of the
largest occupied slot, as tests/test_p3m.py holds the Pallas sweep against
the plain one, and the mesh tiers at 1e-4 relative norm against the JAX
package's accelerations in tests/golden/torch_p3m_plummer_n16384.npz, and
the periodic mesh tiers at 1e-4 against the port on the CPU.
The sharded modes hold the n256_s100 golden trace at %.5g.  The mxu kernel
and the bf16 distance mode hold the same 1e-5 against their plain versions
(the mxu kernel rounds d2 as its plain version does, and sums its 3xTF32
tensor-core products in chunks of 64 sources into a compensated running
sum; below N=2000 the expansion's own error allows 5e-5), and a banded
pair-symmetric or two-sided sweep equals the one-band sweep bit for bit.
The short-range sweep's VJP kernel holds 1e-5 of the largest gp and gm and
1e-4 of grc2 against its plain version, and differentiable P3M's gradient
through it 1e-4 of the largest against the plain backward's.  The CIC
deposit kernel sums in fixed point, so it equals its plain version bit for
bit, and a P3M force call and block through it lie within 1e-6 relative
norm of the same through ``pm._scatter`` (float32 sums, sorted).  The far
field's moments kernel sums in float64 in a fixed order: its table lies
within one float32 ulp of its plain version's and repeats bit for bit; its
target kernel equals PyTorch's nine-call chain bit for bit given the table,
and so does a force call where every body lies inside the box.
Kernel A, the fused columns block and the ring run one source loop
(``nbt::tiled_source_sweep``), so an Euler columns block equals the
unfused block over Kernel A bit for bit; Kernel B, the two-sided sweep and
the fused rows block run one tile body (``nbt::sym_tile_cross``) with R
targets a lane, at every R its launchers pick, and an Euler rows block
equals the unfused block over Kernel B bit for bit at each of them, and
through the engine's runner at the benchmark's N=16384.
"""

import contextlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.models.gravity import make_accel_fn, make_block_fn
from nbody_tpu_torch.models.rollout import make_rollout_fn
from nbody_tpu_torch.ops import (
    deposit_kernel,
    far_field_kernel,
    fused_block,
    grad,
    mxu_kernel,
    naive,
    pm,
    sr_kernel,
    sym_kernel,
    tiled_kernel,
    vjp_kernel,
)
from nbody_tpu_torch.parallel import make_mesh, ring_kernel
from nbody_tpu_torch.parallel.decompose import shard_state
from nbody_tpu_torch.simulation import _DeviceRunner, run
from nbody_tpu_torch.utils import spans
from nbody_tpu_torch.utils.reporting import parse_trace
from tests.torch_health_util import CASES as HEALTH_CASES
from tests.torch_health_util import check_health_equals_the_plan_functions

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, ref):
    return float((got - ref).double().norm() / ref.double().norm())


@pytest.mark.parametrize("n,n_pad", [(2048, 2048), (2000, 2048), (300, 384)])
def test_kernels_match_plain(cuda_device, n, n_pad):
    st = make_state(n, pad_multiple=n_pad, device=cuda_device)
    a0, b0 = tiled_kernel.launches, sym_kernel.launches
    a = tiled_kernel.accelerations(st.pos, st.mass)
    b = sym_kernel.accelerations(st.pos, st.mass)
    torch.cuda.synchronize()
    assert tiled_kernel.launches == a0 + 1 and sym_kernel.launches == b0 + 1
    assert _rel(a, tiled_kernel.accelerations_between_plain(
        st.pos, st.pos, st.mass)) <= 1e-5
    assert _rel(b, sym_kernel.accelerations_plain(st.pos, st.mass)) <= 1e-5
    assert torch.all(b[:, n:] == 0.0)


def test_tiled_kernel_ragged_between(cuda_device):
    gen = torch.Generator(device="cpu").manual_seed(0)
    pt = torch.rand(3, 333, generator=gen).to(cuda_device)
    ps = torch.rand(3, 1001, generator=gen).to(cuda_device)
    ms = (1000 * torch.rand(1001, generator=gen)).to(cuda_device)
    plain = tiled_kernel.accelerations_between_plain(pt, ps, ms)
    for tiles in [(64, 256), (32, 512), (256, 96)]:
        got = tiled_kernel.accelerations_between(pt, ps, ms, *tiles)
        assert _rel(got, plain) <= 1e-5, tiles


# (tile_i, tile_j): the defaults, and tiles that give a thread of the tiled
# sweep 1, 2 or more targets (nbt::tiled_targets).
TILED_TILES = [(0, 0), (32, 256), (64, 256), (128, 64), (256, 96)]


@pytest.mark.parametrize("tiles", TILED_TILES)
@pytest.mark.parametrize("nt,ns", [(300, 300), (1000, 1000), (2000, 2000),
                                   (500, 2000), (500, 500)])
def test_tiled_kernel_ragged_shapes(cuda_device, nt, ns, tiles):
    """Counts that are no multiple of the tiles, at the shapes the main
    paths give Kernel A (one of 4 shards of N=2000 against all sources and
    against one shard): within 1e-5 of the plain version, two launches bit
    for bit."""
    st = make_state(2000, device=cuda_device)
    lo = 0 if nt == ns else 1000
    tgt = st.pos[:, lo:lo + nt].contiguous()
    src, m = st.pos[:, :ns].contiguous(), st.mass[:ns].contiguous()
    got = tiled_kernel.accelerations_between(tgt, src, m, *tiles)
    assert torch.equal(got, tiled_kernel.accelerations_between(tgt, src, m,
                                                               *tiles))
    plain = tiled_kernel.accelerations_between_plain(tgt, src, m)
    assert _rel(got, plain) <= 1e-5


def test_wrappers_raise_on_bad_tiles(cuda_device):
    pos = torch.rand(3, 512, device=cuda_device)
    mass = torch.rand(512, device=cuda_device)
    with pytest.raises(ValueError, match="tile_i"):
        tiled_kernel.accelerations(pos, mass, tile_i=48)
    with pytest.raises(ValueError, match="block"):
        sym_kernel.accelerations(pos, mass, block=512)  # above MAX_BLOCK


@pytest.mark.parametrize("kernel,module", [
    ("auto", sym_kernel), ("pallas_sym", sym_kernel), ("pallas", tiled_kernel),
])
def test_golden_trace_on_card(cuda_device, kernel, module):
    with open(os.path.join(GOLDEN, "ver0_n256_s100.txt")) as f:
        golden = parse_trace(f.read())
    before = module.launches
    res = run(SimConfig(n=256, nsteps=100, kernel=kernel), quiet=True)
    # one launch per step, plus the warm-up block's 50
    assert module.launches - before == 150
    assert [(s, f"{ke:.5g}") for s, ke in res.kenergy_trace] == golden
    assert res.device == torch.cuda.get_device_name(0)


# (tile_i, tile_j): the rows layout with its default block, and the columns
FUSED_TILES = [(0, 0), (64, 256)]


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("tiles", FUSED_TILES, ids=["rows", "columns"])
@pytest.mark.parametrize("n,n_pad", [(2048, 2048), (2000, 2048)])
def test_fused_matches_plain(cuda_device, n, n_pad, tiles, integrator):
    st = make_state(n, pad_multiple=n_pad, device=cuda_device)
    args = (st.pos, st.vel, st.mass, 0.1, 20, *tiles, integrator)
    before = fused_block.launches
    pos, vel = fused_block.fused_block(*args)
    pos2, vel2 = fused_block.fused_block(*args)
    torch.cuda.synchronize()
    assert fused_block.launches == before + 2
    # Two launches on one input agree bit for bit: a barrier race shows here.
    assert torch.equal(pos, pos2) and torch.equal(vel, vel2)
    p_ref, v_ref = fused_block.fused_block_plain(*args)
    assert _rel(pos, p_ref) <= 1e-5 and _rel(vel, v_ref) <= 1e-5
    if tiles == (0, 0):  # rows: a / (G m) gives zero-mass padding exactly 0
        assert torch.all(vel[:, n:] == 0.0)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_fused_rows_ctas_take_many_pairs(cuda_device, integrator):
    """More tile pairs than the card can hold CTAs, so each CTA draws
    several pairs from the counter and reuses its shared memory."""
    n, block = 8192, 64
    props = torch.cuda.get_device_properties(cuda_device)
    most_ctas = props.multi_processor_count * (
        props.max_threads_per_multi_processor // block)
    pairs = (n // block) * (n // block + 1) // 2
    assert pairs > 1.5 * most_ctas
    st = make_state(n, device=cuda_device)
    args = (st.pos, st.vel, st.mass, 0.1, 4, block, block, integrator)
    pos, vel = fused_block.fused_block(*args)
    pos2, vel2 = fused_block.fused_block(*args)
    assert torch.equal(pos, pos2) and torch.equal(vel, vel2)
    p_ref, v_ref = fused_block.fused_block_plain(*args)
    assert _rel(pos, p_ref) <= 1e-5 and _rel(vel, v_ref) <= 1e-5


def test_fused_euler_rows_is_unfused_sym_block(cuda_device):
    """The rows kernel runs Kernel B's arithmetic and the unfused update's
    rounding, so an Euler block equals the unfused block bit for bit."""
    st = make_state(2000, pad_multiple=128, device=cuda_device)
    pos, vel = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 10)
    blk = make_block_fn(make_accel_fn("pallas_sym", tile_i=128), 0.1, 10)
    want, _ = blk(st)
    assert torch.equal(pos, want.pos) and torch.equal(vel, want.vel)


def test_fused_runner_is_the_unfused_runner(cuda_device):
    """The engine at the benchmark's direct cells' shapes: a 50-step block
    at N=16384 through the fused ``_DeviceRunner`` (``direct-n16384-fused``)
    equals the unfused runner's block over Kernel B (``direct-n16384``) bit
    for bit, kinetic energy included, in one launch and no Kernel B sweep;
    ``fused_sweeps`` counts its 50 force sweeps."""
    def runner(fused):
        r = _DeviceRunner(SimConfig(n=16384, nsteps=50, sfreq=50,
                                    fused=fused))
        r.prepare()
        return r

    fused, plain = runner(True), runner(False)
    assert torch.equal(fused.state.pos, plain.state.pos)
    counts = [fused_block.launches, sym_kernel.launches]
    sweeps = spans.counts["fused_sweeps"]
    ke = fused.run_block(50)
    assert [fused_block.launches, sym_kernel.launches] == [counts[0] + 1,
                                                           counts[1]]
    assert spans.counts["fused_sweeps"] - sweeps == 50
    assert plain.run_block(50) == ke
    assert torch.equal(fused.state.pos, plain.state.pos)
    assert torch.equal(fused.state.vel, plain.state.vel)


# Shapes that give the pair-symmetric tile body each R its launchers pick
# (nbt::sym_targets: 2 where the block is a multiple of 64, else 1): Kernel
# B and the fused rows block at (N, block), the two-sided sweep at
# (Nt, Ns, block).
SELF_SHAPES = [(2048, 128), (8192, 128), (16384, 128), (16384, 64),
               (4096, 32)]
CROSS_SHAPES = [(512, 512, 128), (4096, 2048, 128), (4096, 4096, 128),
                (16384, 8192, 128), (1024, 512, 32)]


def _every_targets():
    return {sym_kernel.lane_targets(b)
            for b in range(32, sym_kernel.MAX_BLOCK + 1, 32)}


def test_sym_kernel_at_each_targets(cuda_device):
    """Kernel B at shapes that give a lane each R its launcher can pick:
    within 1e-5 of its plain version, two launches bit for bit, zero-mass
    padding exactly 0."""
    seen = set()
    for n, block in SELF_SHAPES:
        r = sym_kernel.lane_targets(block)
        seen.add(r)
        st = make_state(n - 24, pad_multiple=block, device=cuda_device)
        got = sym_kernel.accelerations(st.pos, st.mass, block=block)
        again = sym_kernel.accelerations(st.pos, st.mass, block=block)
        plain = sym_kernel.accelerations_plain(st.pos, st.mass, block)
        assert _rel(got, plain) <= 1e-5, (n, block, r)
        assert torch.equal(got, again), (n, block, r)
        assert torch.all(got[:, n - 24:] == 0), (n, block, r)
    assert seen == _every_targets()


def test_two_sided_kernel_at_each_targets(cuda_device):
    seen = set()
    for nt, ns, block in CROSS_SHAPES:
        seen.add(sym_kernel.lane_targets(block))
        a = make_state(nt - 40, pad_multiple=nt, seed=1, device=cuda_device)
        b = make_state(ns - 24, pad_multiple=ns, seed=2, device=cuda_device)
        args = (a.pos, a.mass, b.pos, b.mass)
        t, s = sym_kernel.accelerations_two_sided(*args, block=block)
        t2, s2 = sym_kernel.accelerations_two_sided(*args, block=block)
        tp, sp = sym_kernel.accelerations_two_sided_plain(*args, block=block)
        assert _rel(t, tp) <= 1e-5 and _rel(s, sp) <= 1e-5, (nt, ns, block)
        assert torch.equal(t, t2) and torch.equal(s, s2), (nt, ns, block)
        assert torch.all(t[:, nt - 40:] == 0) and torch.all(s[:, ns - 24:] == 0)
    assert seen == _every_targets()


@pytest.mark.parametrize("n,block", SELF_SHAPES[2:])
def test_fused_euler_rows_is_unfused_at_each_targets(cuda_device, n, block):
    """The rows kernel takes Kernel B's R at the same block, so an
    Euler block equals the unfused block over Kernel B bit for bit at every
    CTA shape."""
    st = make_state(n, device=cuda_device)
    pos, vel = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 3,
                                       block)
    blk = make_block_fn(make_accel_fn("pallas_sym", tile_i=block), 0.1, 3)
    want, _ = blk(st)
    assert torch.equal(pos, want.pos) and torch.equal(vel, want.vel)


def test_fused_euler_columns_is_unfused_tiled_block(cuda_device):
    """The columns kernel runs Kernel A's source loop and the unfused
    update's rounding, so an Euler block equals the unfused block over
    Kernel A at the same tiles bit for bit."""
    st = make_state(2000, pad_multiple=256, device=cuda_device)
    pos, vel = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 10, 64,
                                       256)
    blk = make_block_fn(make_accel_fn("pallas", tile_i=64, tile_j=256), 0.1,
                        10)
    want, _ = blk(st)
    assert torch.equal(pos, want.pos) and torch.equal(vel, want.vel)


@pytest.mark.parametrize("tiles", FUSED_TILES, ids=["rows", "columns"])
def test_fused_golden_trace_on_card(cuda_device, tiles):
    with open(os.path.join(GOLDEN, "ver0_n256_s100.txt")) as f:
        golden = parse_trace(f.read())
    counts = [m.launches for m in (fused_block, sym_kernel, tiled_kernel)]
    res = run(SimConfig(n=256, nsteps=100, fused=True, tile_i=tiles[0],
                        tile_j=tiles[1]), quiet=True)
    # one launch per block, plus the warm-up block's; no unfused sweep
    assert [m.launches for m in (fused_block, sym_kernel, tiled_kernel)] == [
        counts[0] + 3, counts[1], counts[2]]
    assert [(s, f"{ke:.5g}") for s, ke in res.kenergy_trace] == golden


def test_fused_raises_on_bad_tiles(cuda_device):
    st = make_state(512, device=cuda_device)
    with pytest.raises(ValueError, match="block"):
        fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 1, tile_i=512)
    with pytest.raises(ValueError, match="tile_i"):
        fused_block.fused_block(st.pos, st.vel, st.mass, 0.1, 1, tile_i=512,
                                tile_j=256)


@pytest.mark.parametrize("tiles", [(0, 0), (32, 64), (64, 512), (64, 256),
                                   (128, 1024), (256, 8)])
@pytest.mark.parametrize("n", [300, 1000, 2000])
def test_vjp_kernel_matches_plain(cuda_device, n, tiles):
    """Ragged N: the kernel masks targets and sources past N itself."""
    st = make_state(n, device=cuda_device)
    g = naive.accelerations(st.pos, st.mass) * 1e20
    before = vjp_kernel.launches
    d_pos, d_mass = vjp_kernel.force_vjp(st.pos, st.mass, g, *tiles)
    again = vjp_kernel.force_vjp(st.pos, st.mass, g, *tiles)
    torch.cuda.synchronize()
    assert vjp_kernel.launches == before + 2
    assert torch.equal(d_pos, again[0]) and torch.equal(d_mass, again[1])
    want = grad.force_vjp(st.pos, st.mass, g)
    assert _rel(d_pos, want[0]) <= 2e-5 and _rel(d_mass, want[1]) <= 2e-5


def test_vjp_kernel_default_tiles(cuda_device):
    """The default tile_i, Kernel A's rule: 64 (two targets a thread)
    where it gives each SM a CTA, else 32 (one), both with tile_j 512: the
    default call equals the named tiles bit for bit."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n in (64 * sms, 2048):
        st = make_state(n, device=cuda_device)
        g = naive.accelerations(st.pos, st.mass) * 1e20
        ti = 64 if n >= 64 * sms else 32
        assert tiled_kernel.default_tile_i(n, cuda_device) == ti
        got = vjp_kernel.force_vjp(st.pos, st.mass, g)
        want = vjp_kernel.force_vjp(st.pos, st.mass, g, ti,
                                    vjp_kernel.DEFAULT_TILE_J)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_vjp_kernel_zero_cotangent_and_bad_tiles(cuda_device):
    st = make_state(512, device=cuda_device)
    d_pos, d_mass = vjp_kernel.force_vjp(st.pos, st.mass,
                                         torch.zeros_like(st.pos))
    assert torch.all(d_pos == 0) and torch.all(d_mass == 0)
    with pytest.raises(ValueError, match="tile_i"):
        vjp_kernel.force_vjp(st.pos, st.mass, st.pos, tile_i=48)
    with pytest.raises(ValueError, match="tile_j"):
        vjp_kernel.force_vjp(st.pos, st.mass, st.pos, tile_j=2048)


def test_kernels_refuse_inputs_that_require_grad(cuda_device):
    """A ctypes launch is invisible to autograd: the CUDA branches raise
    rather than return a tensor with no grad_fn."""
    st = make_state(256, device=cuda_device)
    pos = st.pos.clone().requires_grad_(True)
    calls = [
        lambda: tiled_kernel.accelerations(pos, st.mass),
        lambda: tiled_kernel.accelerations_between(pos, st.pos, st.mass),
        lambda: sym_kernel.accelerations(pos, st.mass),
        lambda: fused_block.fused_block(pos, st.vel, st.mass, 0.1, 2),
        lambda: vjp_kernel.force_vjp(pos, st.mass, st.pos),
        lambda: sym_kernel.accelerations_two_sided(pos, st.mass, st.pos,
                                                   st.mass),
        lambda: ring_kernel.ring_accelerations([pos], [st.mass]),
        lambda: mxu_kernel.accelerations(pos, st.mass),
    ]
    for call in calls:
        with pytest.raises(RuntimeError,
                           match=r"make_accel_fn\(\.\.\., differentiable=True\)"):
            call()
    with torch.no_grad():  # what the analytic VJP's forward does
        assert sym_kernel.accelerations(pos, st.mass).grad_fn is None


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_rollout_grads_on_card(cuda_device, integrator):
    """Kernel forward, kernel backward: the gradients agree with the plain
    backward, and remat recomputes the deterministic forward bit for bit."""
    st = make_state(1024, device=cuda_device)
    with torch.no_grad():
        target = make_rollout_fn(make_accel_fn("auto"), 0.1, 4, integrator)(
            st.pos, st.vel, st.mass)[0]

    def grads(remat=True, backward_opts=None):
        accel = make_accel_fn("auto", differentiable=True,
                              backward_opts=backward_opts)
        vel = (0.5 * st.vel).requires_grad_(True)
        mass = st.mass.clone().requires_grad_(True)
        p = make_rollout_fn(accel, 0.1, 4, integrator, remat)(st.pos, vel, mass)[0]
        torch.sum((p - target) ** 2).backward()
        return vel.grad, mass.grad

    before = vjp_kernel.launches
    got = grads()
    # The loss reads only the positions, so the last leapfrog step's closing
    # kick, which moves only the velocities, has no backward to run.
    sweeps = 4 if integrator == "euler" else 2 * 4 - 1
    assert vjp_kernel.launches - before == sweeps
    for a, b in zip(got, grads(remat=False)):
        assert torch.equal(a, b)
    for a, b in zip(got, grads(backward_opts={"backward": "jnp"})):
        assert _rel(a, b) <= 1e-4


def _sr_inputs(device, layout, n=8192, seed=3):
    """Packed tables and worklist of a Plummer sphere at the plan suggested
    for ``layout`` on the card."""
    pos, _, mass = distributions.plummer(n, seed=seed)
    p = torch.tensor(pos, device=device)
    m = torch.tensor(mass, device=device)
    sym, paired = pm.SR_LAYOUTS[layout]
    plan = pm.suggest_sr_plan(p, m, 64, 4, layout=layout)
    pk = pm.sr_pack_inputs(p, m, grid=64, cutoff_cells=4, symmetric=sym,
                           paired=paired, **plan)
    bounds = torch.stack([torch.zeros_like(pk["n_e"]),
                          pk["n_e"].clamp(max=pk["e_max"])])
    return pk, bounds, sym, paired


@pytest.mark.parametrize("layout", sorted(pm.SR_LAYOUTS))
def test_sr_kernel_matches_plain(cuda_device, layout):
    pk, bounds, sym, paired = _sr_inputs(cuda_device, layout)
    args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"], bounds, pk["rc2"])
    before = sr_kernel.launches
    got = sr_kernel.sweep(*args, symmetric=sym, paired=paired)
    again = sr_kernel.sweep(*args, symmetric=sym, paired=paired)
    torch.cuda.synchronize()
    assert sr_kernel.launches == before + 2
    want = sr_kernel.sweep_plain(*args, symmetric=sym, paired=paired)
    occ = pk["mtab"] > 0
    scale = float(want[:, occ].abs().max())
    assert float((got - want)[:, occ].abs().max()) <= 2e-5 * scale
    if sym:  # the reaction's atomics add in another order each launch
        assert _rel(again[:, occ], got[:, occ]) <= 1e-6
    else:
        assert torch.equal(got, again)
    assert bool((got[:, -pm.SLAB:] == 0).all())


@pytest.mark.parametrize("layout", ["pallas_paired_sym", "pallas_paired",
                                    "pallas", "pallas_sym"])
@pytest.mark.parametrize("skew", [0, 3])
def test_sr_kernel_bounds_split(cuda_device, layout, skew):
    """Four bounds, at multiples of the kernel's unit (skew 0) and cutting
    units and runs anywhere (skew 3), sum to the full sweep."""
    pk, bounds, sym, paired = _sr_inputs(cuda_device, layout)
    args = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
    full = sr_kernel.sweep(*args, bounds, pk["rc2"], symmetric=sym,
                           paired=paired)
    n_e = int(bounds[1])
    per = -(-n_e // 4) + skew
    parts = sum(sr_kernel.sweep(
        *args, torch.tensor([i * per, min((i + 1) * per, n_e)],
                            dtype=torch.int32, device=cuda_device),
        pk["rc2"], symmetric=sym, paired=paired) for i in range(4))
    occ = pk["mtab"] > 0
    scale = float(full[:, occ].abs().max())
    assert float(((parts - full).abs() - 1e-6 * full.abs())[:, occ].max()) \
        <= 2e-6 * scale


@pytest.mark.parametrize("layout", ["pallas_paired", "pallas_paired_sym"])
def test_sr_kernel_ragged_worklist(cuda_device, layout):
    """A worklist whose length is no multiple of the kernel's unit (its
    scratch and grid follow e_max), with bounds that start and end inside
    units and runs, against the plain sweep on the same bounds."""
    pk, bounds, sym, paired = _sr_inputs(cuda_device, layout)
    n_e = int(bounds[1])
    cut = n_e + 7
    tabs = (pk["ptab"], pk["mtab"], pk["wl_t"][:cut].contiguous(),
            pk["wl_s"][:cut].contiguous())
    b = torch.tensor([5, n_e - 9], dtype=torch.int32, device=cuda_device)
    got = sr_kernel.sweep(*tabs, b, pk["rc2"], symmetric=sym, paired=paired)
    want = sr_kernel.sweep_plain(*tabs, b, pk["rc2"], symmetric=sym,
                                 paired=paired)
    occ = pk["mtab"] > 0
    scale = float(want[:, occ].abs().max())
    assert float((got - want)[:, occ].abs().max()) <= 2e-5 * scale


def test_mesh_tiers_match_jax_fixture(cuda_device):
    fx = np.load(os.path.join(GOLDEN, "torch_p3m_plummer_n16384.npz"))
    pos, _, mass = distributions.plummer(int(fx["n"]), seed=int(fx["seed"]))
    p = torch.tensor(pos, device=cuda_device)
    m = torch.tensor(mass, device=cuda_device)
    ng = int(fx["grid"])
    a_pm = pm.accelerations(p, m, grid=ng)
    assert _rel(a_pm.cpu(), torch.tensor(fx["pm"])) <= 1e-4
    plan = pm.suggest_sr_plan(p, m, ng, int(fx["cutoff"]),
                              capacity=int(fx["capacity"]))
    before = sr_kernel.launches
    a_p3m = pm.p3m_accelerations(p, m, grid=ng, **plan)
    assert sr_kernel.launches == before + 1
    assert _rel(a_p3m.cpu(), torch.tensor(fx["p3m"])) <= 1e-4


def test_p3m_run_goes_through_the_sr_kernel(cuda_device):
    sr_kernel.launches = tiled_kernel.launches = sym_kernel.launches = 0
    res = run(SimConfig(n=4096, nsteps=8, sfreq=4, kernel="p3m",
                        distribution="plummer", dt=0.01, seed=7), quiet=True)
    assert (sr_kernel.launches, tiled_kernel.launches,
            sym_kernel.launches) == (12, 0, 0)
    assert all(np.isfinite(ke) and ke > 0 for _, ke in res.kenergy_trace)


def test_sr_kernel_refuses_inputs_that_require_grad(cuda_device):
    pk, bounds, sym, paired = _sr_inputs(cuda_device, "pallas", n=1024)
    ptab = pk["ptab"].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="differentiable=True"):
        sr_kernel.sweep(ptab, pk["mtab"], pk["wl_t"], pk["wl_s"], bounds,
                        pk["rc2"])


@pytest.mark.parametrize("nt_real,nt,ns_real,ns", [
    (4096, 4096, 4000, 4096), (3000, 4096, 1000, 2048), (256, 256, 512, 512)])
def test_two_sided_kernel_matches_plain(cuda_device, nt_real, nt, ns_real, ns):
    a = make_state(nt_real, pad_multiple=nt, seed=1, device=cuda_device)
    b = make_state(ns_real, pad_multiple=ns, seed=2, device=cuda_device)
    args = (a.pos, a.mass, b.pos, b.mass)
    before = sym_kernel.two_sided_launches
    t, s = sym_kernel.accelerations_two_sided(*args)
    t2, s2 = sym_kernel.accelerations_two_sided(*args)
    assert sym_kernel.two_sided_launches == before + 2
    tp, sp = sym_kernel.accelerations_two_sided_plain(*args)
    assert _rel(t, tp) <= 1e-5 and _rel(s, sp) <= 1e-5
    assert torch.equal(t, t2) and torch.equal(s, s2)
    assert torch.all(t[:, nt_real:] == 0) and torch.all(s[:, ns_real:] == 0)


@pytest.mark.parametrize("n,k", [(4096, 1), (4096, 2), (4096, 3), (4096, 4),
                                 (4096, 8), (65536, 8)])
def test_ring_kernel_matches_plain(cuda_device, n, k):
    """At N=65536, K=8 the group's CTAs own several target tiles each."""
    st = make_state(n, pad_multiple=64 * k, device=cuda_device)
    sharded, _ = shard_state(st, k, make_mesh(k))
    pos, mass = list(sharded.pos), list(sharded.mass)
    before = ring_kernel.launches
    got = ring_kernel.ring_accelerations(pos, mass)
    again = ring_kernel.ring_accelerations(pos, mass)
    assert ring_kernel.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    whole = torch.cat(got, dim=1)
    assert _rel(whole, tiled_kernel.accelerations(st.pos, st.mass)) <= 1e-5
    if n <= 4096:
        plain = torch.cat(ring_kernel.ring_accelerations_plain(pos, mass), 1)
        assert _rel(whole, plain) <= 1e-5


@pytest.mark.parametrize("comm,k", [("allgather", 4), ("ring", 4),
                                    ("ring_sym", 4), ("rdma", 4),
                                    ("ring_sym", 3), ("rdma", 3)])
def test_sharded_golden_trace_on_card(cuda_device, comm, k):
    with open(os.path.join(GOLDEN, "ver0_n256_s100.txt")) as f:
        golden = parse_trace(f.read())
    mods = (tiled_kernel, sym_kernel, ring_kernel)
    for mod in mods:
        mod.launches = 0
    sym_kernel.two_sided_launches = 0
    res = run(SimConfig(n=256, nsteps=100, shards=k, comm=comm), quiet=True)
    assert [(s, f"{ke:.5g}") for s, ke in res.kenergy_trace] == golden
    counts = tuple(m.launches for m in mods) + (sym_kernel.two_sided_launches,)
    steps = 150  # 100 and the warm-up block's 50
    pairs = k * ((k - 1) // 2) + (k // 2 if k % 2 == 0 else 0)
    want = {"allgather": (k * steps, 0, 0, 0),
            "ring": (k * k * steps, 0, 0, 0),
            "ring_sym": (0, k * steps, 0, pairs * steps),
            "rdma": (0, 0, steps, 0)}[comm]
    assert counts == want


# (tile_i, tile_j): the defaults; 8 warps splitting each source tile; 4 warps
# of targets; 8 warps of targets at the largest and the smallest tile_j.
@pytest.mark.parametrize("tiles", [(0, 0), (16, 512), (64, 256), (128, 2048),
                                   (128, 8)])
@pytest.mark.parametrize("n,n_pad", [(2048, 2048), (2000, 2048), (3001, 3001),
                                     (1000, 1000), (300, 384)])
def test_mxu_kernel_matches_plain(cuda_device, n, n_pad, tiles):
    """At N <= 512 the expansion's own error against float64 is above 1e-5
    (tests/test_torch_mxu.py), so there two fp32 implementations agree to
    5e-5; from N=2000 on the kernel holds 1e-5 against its plain version."""
    st = make_state(n, pad_multiple=n_pad, device=cuda_device)
    before = mxu_kernel.launches
    got = mxu_kernel.accelerations(st.pos, st.mass, *tiles)
    again = mxu_kernel.accelerations(st.pos, st.mass, *tiles)
    torch.cuda.synchronize()
    assert mxu_kernel.launches == before + 2
    assert torch.equal(got, again)
    plain = mxu_kernel.accelerations_between_plain(st.pos, st.pos, st.mass)
    assert _rel(got[:, :n], plain[:, :n]) <= (1e-5 if n >= 2000 else 5e-5)
    f64 = naive.accelerations(st.pos.double(), st.mass.double())
    assert _rel(got[:, :n], f64[:, :n]) < 1e-4
    assert torch.isfinite(got).all()
    if n_pad > n:  # padded sources add exactly nothing
        real = [t.contiguous() for t in (st.pos[:, :n], st.mass[:n])]
        assert torch.equal(mxu_kernel.accelerations(*real, *tiles), got[:, :n])


@pytest.mark.parametrize("nt,ns", [(500, 2000), (500, 500)])
def test_mxu_between_matches_plain(cuda_device, nt, ns):
    """The between form at one shard's shapes of N=2000 over 4 shards:
    allgather's 500 x 2000 and ring's 500 x 500."""
    st = make_state(2000, device=cuda_device)
    tgt = st.pos[:, 1000:1000 + nt].contiguous()
    src, m = st.pos[:, :ns].contiguous(), st.mass[:ns].contiguous()
    got = mxu_kernel.accelerations_between(tgt, src, m)
    assert torch.equal(got, mxu_kernel.accelerations_between(tgt, src, m))
    plain = mxu_kernel.accelerations_between_plain(tgt, src, m)
    assert _rel(got, plain) <= 1e-5


def test_mxu_kernel_bad_tiles_and_bf16(cuda_device):
    st = make_state(512, device=cuda_device)
    with pytest.raises(ValueError, match="tile_j"):
        mxu_kernel.accelerations(st.pos, st.mass, tile_j=3072)
    with pytest.raises(ValueError, match="tile_i"):
        mxu_kernel.accelerations(st.pos, st.mass, tile_i=256)
    with pytest.raises(ValueError, match="fp32 distances"):
        mxu_kernel.accelerations(st.pos, st.mass, dist_dtype="bfloat16")


def test_mxu_run_on_card(cuda_device):
    mxu_kernel.launches = tiled_kernel.launches = sym_kernel.launches = 0
    res = run(SimConfig(n=256, nsteps=100, kernel="pallas_mxu"), quiet=True)
    assert (mxu_kernel.launches, tiled_kernel.launches,
            sym_kernel.launches) == (150, 0, 0)
    ref = run(SimConfig(n=256, nsteps=100, kernel="pallas"), quiet=True)
    for (_, ke), (_, want) in zip(res.kenergy_trace, ref.kenergy_trace):
        assert abs(ke - want) <= 1e-4 * abs(want)


@pytest.mark.parametrize("n,n_pad", [(2048, 2048), (2000, 2048)])
def test_bf16_kernels_match_plain(cuda_device, n, n_pad):
    bf = "bfloat16"
    st = make_state(n, pad_multiple=n_pad, device=cuda_device)
    a = tiled_kernel.accelerations(st.pos, st.mass, dist_dtype=bf)
    b = sym_kernel.accelerations(st.pos, st.mass, dist_dtype=bf)
    torch.cuda.synchronize()
    assert torch.equal(a, tiled_kernel.accelerations(st.pos, st.mass,
                                                     dist_dtype=bf))
    assert torch.equal(b, sym_kernel.accelerations(st.pos, st.mass,
                                                   dist_dtype=bf))
    assert _rel(a, tiled_kernel.accelerations_between_plain(
        st.pos, st.pos, st.mass, dist_dtype=bf)) <= 1e-5
    assert _rel(b, sym_kernel.accelerations_plain(st.pos, st.mass,
                                                  dist_dtype=bf)) <= 1e-5
    assert not torch.equal(b, sym_kernel.accelerations(st.pos, st.mass))
    half = n_pad // 2
    args = (st.pos[:, :half].contiguous(), st.mass[:half].contiguous(),
            st.pos[:, half:].contiguous(), st.mass[half:].contiguous())
    got = sym_kernel.accelerations_two_sided(*args, dist_dtype=bf)
    want = sym_kernel.accelerations_two_sided_plain(*args, dist_dtype=bf)
    assert all(_rel(x, y) <= 1e-5 for x, y in zip(got, want))


def test_bf16_ring_sym_run_on_card(cuda_device):
    """ring_sym in bf16: Kernel B and the two-sided sweep launch in the mode
    (K and K floor((K-1)/2) + K/2 a step), and the trace stays within 1e-4
    of the f32 run without equalling it."""
    kes = {}
    for precision in ("f32", "bf16"):
        sym_kernel.launches = sym_kernel.two_sided_launches = 0
        tiled_kernel.launches = 0
        res = run(SimConfig(n=256, nsteps=100, shards=4, comm="ring_sym",
                            precision=precision), quiet=True)
        assert (sym_kernel.launches, sym_kernel.two_sided_launches,
                tiled_kernel.launches) == (4 * 150, 6 * 150, 0)
        kes[precision] = [ke for _, ke in res.kenergy_trace]
    assert kes["bf16"] != kes["f32"]
    for ke, ke32 in zip(kes["bf16"], kes["f32"]):
        assert abs(ke - ke32) <= 1e-4 * abs(ke32)


def test_banded_sweeps_equal_one_band(cuda_device):
    st = make_state(4096, device=cuda_device)
    one = sym_kernel.accelerations(st.pos, st.mass)
    for bands in (1, 5, 13):
        budget = sym_kernel.band_bytes(4096, 128, bands)
        assert torch.equal(sym_kernel.accelerations(
            st.pos, st.mass, scratch_budget=budget), one)
    args = (st.pos[:, :2048].contiguous(), st.mass[:2048].contiguous(),
            st.pos[:, 2048:].contiguous(), st.mass[2048:].contiguous())
    one = sym_kernel.accelerations_two_sided(*args)
    banded = sym_kernel.accelerations_two_sided(*args,
                                                scratch_budget=24 * 3 * 2048)
    assert all(torch.equal(a, b) for a, b in zip(banded, one))


def test_profile_dir_traces_the_card(cuda_device, tmp_path):
    """--profile-dir on the card: the trace holds the blocks' kernels and
    the program's spans from set-up on."""
    run(SimConfig(n=256, nsteps=100, profile_dir=str(tmp_path),
                  debug_nans=True), quiet=True)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    assert any("sym_pairs_kernel" in name for name in names)
    assert {"nbt.setup.state", "nbt.setup.warm", "nbt.block",
            "nbt.sync.finite"} <= {e.get("name", "") for e in events}


@pytest.mark.parametrize("cell", ["p3m open", "p3m periodic", "direct"])
def test_every_sync_is_counted(cuda_device, monkeypatch, cell):
    """Every synchronizing CUDA op of a block and its health check sits in
    a counted ``spans.sync``: under ``set_sync_debug_mode("warn")`` each
    warning comes while one is open, and there are as many as the
    ``host_syncs`` counter's delta."""
    kw = {"p3m open": dict(kernel="p3m", distribution="plummer", seed=7,
                           pm_grid=64, dt=0.01),
          "p3m periodic": dict(kernel="p3m", pm_boundary="periodic",
                               pm_box=1.0, pm_grid=64, dt=0.01),
          "direct": dict()}[cell]
    steps = 50 if cell == "direct" else 4
    runner = _DeviceRunner(SimConfig(n=16384, nsteps=2 * steps, sfreq=steps,
                                     **kw))
    runner.prepare()
    runner.run_block(steps)
    runner.check_sr_health()
    open_sites = []
    sync = spans.sync

    @contextlib.contextmanager
    def marked(site):
        with sync(site):
            open_sites.append(site)
            try:
                yield
            finally:
                open_sites.pop()

    monkeypatch.setattr(spans, "sync", marked)
    seen = []

    def show(message, *_args, **_kw):
        if "synchronizing CUDA operation" in str(message):
            seen.append(open_sites[-1] if open_sites else None)

    before = spans.counts["host_syncs"]
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.run_block(steps)
            runner.check_sr_health()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    runner.finish()
    assert None not in seen
    assert len(seen) == spans.counts["host_syncs"] - before > 0


@pytest.mark.parametrize("name", sorted(HEALTH_CASES))
def test_sr_plan_health_equals_the_plan_functions(cuda_device, name):
    """The health check's one-binning triple equals the three public plan
    functions' in the card's paired layout, the 7N fallback included."""
    check_health_equals_the_plan_functions(name, cuda_device)


def _periodic_state(kind, n=4096, seed=5):
    """Uniform in the unit box, or the Gaussian blob wrapped round a box
    corner (chip_smoke.corner_blob)."""
    if kind == "blob":
        from chip_smoke import corner_blob

        return corner_blob(n, seed)
    rng = np.random.default_rng(seed)
    return (np.asarray(rng.random((3, n)), np.float32),
            np.asarray(1.0 + rng.random(n), np.float32))


@pytest.mark.parametrize("kind", ["uniform", "blob"])
@pytest.mark.parametrize("cutoff", [0, 4])
def test_periodic_mesh_tiers_match_cpu(cuda_device, kind, cutoff):
    """Periodic pm and p3m on the card (cuFFT, the SR kernel in the card's
    layout) against the port on the CPU (plain sweep), one plan sized for
    the full worklist: 1e-4 relative norm."""
    pos, mass = _periodic_state(kind)
    cpu = (torch.tensor(pos), torch.tensor(mass))
    card = tuple(t.to(cuda_device) for t in cpu)
    kw = dict(grid=64, cutoff_cells=cutoff, boundary="periodic", box_size=1.0)
    plan = pm.suggest_sr_plan(*cpu, 64, 4, layout="full", boundary="periodic",
                              box_size=1.0) if cutoff else {}
    before = sr_kernel.launches
    got = pm.accelerations(*card, **plan, **kw)
    assert sr_kernel.launches == before + bool(cutoff)
    want = pm.accelerations(*cpu, **plan, **kw)
    assert _rel(got.cpu(), want) <= 1e-4
    env = pm.make_mesh_env(*card, **kw)
    assert torch.equal(pm.accelerations(*card, mesh_env=env, **plan, **kw),
                       got)


def test_periodic_run_goes_through_the_sr_kernel(cuda_device):
    for kernel, want in (("p3m", 12), ("pm", 0)):
        sr_kernel.launches = tiled_kernel.launches = sym_kernel.launches = 0
        res = run(SimConfig(n=4096, nsteps=8, sfreq=4, kernel=kernel,
                            pm_boundary="periodic", pm_box=1.0, dt=0.01),
                  quiet=True)
        assert (sr_kernel.launches, tiled_kernel.launches,
                sym_kernel.launches) == (want, 0, 0)
        assert all(np.isfinite(ke) and ke > 0 for _, ke in res.kenergy_trace)


def _long_runs(pk):
    """A t-major worklist on the tables of ``pk`` whose longest runs span
    many units of the VJP kernel on both sides: slab c (the target of the
    plan's longest run, in the dense core) takes every slab three times as
    its sources, and every other slab takes slab c five times, then itself.
    Returns (wl_t, wl_s, bounds)."""
    nslab = pk["ptab"].shape[1] // pm.SLAB
    c = int(torch.mode(pk["wl_t"][:int(pk["n_e"])].cpu()).values)
    pairs = []
    for t in range(nslab):
        pairs += ([(t, s) for s in range(nslab) for _ in range(3)] if t == c
                  else [(t, c)] * 5 + [(t, t)])
    wl = torch.tensor(pairs, dtype=torch.int32, device=pk["ptab"].device)
    bounds = torch.tensor([0, len(pairs)], dtype=torch.int32,
                          device=wl.device)
    return wl[:, 0].contiguous(), wl[:, 1].contiguous(), bounds


@pytest.mark.parametrize("worklist", ["plan", "long runs"])
@pytest.mark.parametrize("layout", ["pallas", "pallas_sym"])
def test_sr_vjp_kernel_matches_plain(cuda_device, layout, worklist):
    """The short-range sweep's VJP kernel against its plain version: gp and
    gm within 1e-5 of each one's largest, grc2 within 1e-4 relative; two
    launches repeat bit for bit.  Also on a worklist whose longest run spans
    many units on both sides, where each run's unit partials are added by
    the finalize kernels."""
    pk, bounds, sym, _ = _sr_inputs(cuda_device, layout)
    wl_t, wl_s = pk["wl_t"], pk["wl_s"]
    if worklist == "long runs":
        wl_t, wl_s, bounds = _long_runs(pk)
    g = torch.tensor(np.random.default_rng(7).standard_normal(
        pk["ptab"].shape).astype(np.float32), device=cuda_device)
    args = (pk["ptab"], pk["mtab"], wl_t, wl_s, bounds, pk["rc2"], g)
    before = sr_kernel.vjp_launches
    got = sr_kernel.sweep_vjp(*args, symmetric=sym)
    again = sr_kernel.sweep_vjp(*args, symmetric=sym)
    torch.cuda.synchronize()
    assert sr_kernel.vjp_launches == before + 2
    want = sr_kernel.sweep_vjp_plain(*args, symmetric=sym)
    for i, tol in enumerate((1e-5, 1e-5, 1e-4)):
        scale = float(want[i].abs().max())
        assert scale > 0
        assert float((got[i] - want[i]).abs().max()) <= tol * scale
        assert torch.equal(got[i], again[i])


def test_differentiable_p3m_on_card(cuda_device, monkeypatch):
    """differentiable=True: the forward equals the non-differentiable call
    in the pinned pallas layout bit for bit; the gradient through the VJP
    kernel agrees with the plain backward's (the kernel swapped for its
    plain version) within 1e-4 of its largest."""
    pos, _, mass = distributions.plummer(8192, seed=3)
    p = torch.tensor(pos, device=cuda_device)
    m = torch.tensor(mass, device=cuda_device)
    kw = dict(grid=64, cutoff_cells=4)
    plan = pm.suggest_sr_plan(p, m, 64, 4, differentiable=True)
    prev = pm.set_sr_layout("pallas")
    try:
        pinned = pm.accelerations(p, m, **kw, **plan)
    finally:
        pm.set_sr_layout(prev)
    assert torch.equal(pm.accelerations(p, m, differentiable=True, **kw,
                                        **plan), pinned)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(sr_kernel, "sweep_vjp",
                                sr_kernel.sweep_vjp_plain)
        fwd, vjp = sr_kernel.launches, sr_kernel.vjp_launches
        q = p.clone().requires_grad_(True)
        torch.mean(pm.accelerations(q, m, differentiable=True, **kw,
                                    **plan) ** 2).backward()
        assert sr_kernel.launches == fwd + 1
        assert sr_kernel.vjp_launches == vjp + (not plain)
        grads.append(q.grad)
    scale = float(grads[1].abs().max())
    assert scale > 0
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-4 * scale


def _deposit_state(kind, n, device):
    """(pos, mass) on the card: the reference initial conditions (uniform)
    or the Plummer sphere of the P3M gate, the first ``n`` bodies."""
    if kind == "uniform":
        st = make_state(1048576, device=device)
        return st.pos[:, :n].contiguous(), st.mass[:n].contiguous()
    pos, _, mass = distributions.plummer(n, seed=7)
    return torch.tensor(pos, device=device), torch.tensor(mass, device=device)


def _deposit_args(pos, mass, boundary, ng=128):
    """The solver's deposit arguments: the open mesh over the state's
    robust box and the in-box masses, or the periodic box of edge 1."""
    if boundary == "periodic":
        return mass, dict(box=1.0)
    mesh = pm._OpenMesh(ng, *pm._robust_box(pos, mass))
    return mesh.bodies(pos, mass, pos)[1], dict(lo=mesh.lo, inv_h=mesh.inv_h)


@pytest.mark.parametrize("boundary", ["open", "periodic"])
@pytest.mark.parametrize("kind,n", [("uniform", 1048576), ("plummer", 262144),
                                    ("uniform", 300001)])
def test_deposit_kernel_matches_plain(cuda_device, kind, n, boundary):
    """The fixed-point deposit kernel equals its plain version bit for bit
    and repeats bit for bit; it lies within 1e-6 relative norm of
    ``_scatter``'s grid."""
    pos, mass = _deposit_state(kind, n, cuda_device)
    m, kw = _deposit_args(pos, mass, boundary)
    before = deposit_kernel.launches
    got = deposit_kernel.deposit(pos, m, 128, **kw)
    again = deposit_kernel.deposit(pos, m, 128, **kw)
    assert deposit_kernel.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, deposit_kernel.deposit_plain(pos, m, 128, **kw))
    scatter = pm._scatter(deposit_kernel._corners(pos, 128, **kw), m, 128)
    assert _rel(got, scatter) <= 1e-6
    assert float(got.double().sum()) == pytest.approx(
        float(m.double().sum()), rel=1e-6)


@pytest.mark.parametrize("boundary", ["open", "periodic"])
def test_p3m_through_the_deposit_kernel_is_scatters(cuda_device, monkeypatch,
                                                    boundary):
    """A force call and a 4-step block of the benchmark's N=1048576 P3M
    cells (reference initial conditions, dt 0.001, ng 128, cutoff 4,
    capacity 16384 open and 128 periodic) through the deposit kernel
    against the same through ``_scatter``: within 1e-6 relative norm; one
    kernel launch a force call (no body overflows its cell)."""
    periodic = boundary == "periodic"
    cfg = SimConfig(n=1048576, nsteps=4, sfreq=4, kernel="p3m", dt=0.001,
                    pm_capacity=128 if periodic else 16384,
                    **(dict(pm_boundary="periodic", pm_box=1.0)
                       if periodic else {}))
    runner = _DeviceRunner(cfg)
    runner.prepare()
    try:
        st = runner.state
        block, accel = runner._block_for(4), runner.accel_fn
        results = []
        for hand in (True, False):
            if not hand:
                monkeypatch.setattr(pm, "_hand_deposit", lambda *t: False)
            before = deposit_kernel.launches
            a = accel(st.pos, st.mass)
            new, _ = block(st)
            torch.cuda.synchronize()
            results.append((a, new.vel - st.vel,
                            deposit_kernel.launches - before))
    finally:
        runner.finish()
    (a_k, dv_k, n_k), (a_s, dv_s, n_s) = results
    assert (n_k, n_s) == (5, 0)
    assert _rel(a_k, a_s) <= 1e-6
    assert _rel(dv_k, dv_s) <= 1e-6


def test_deposit_kernel_launches_a_force_call(cuda_device):
    """One deposit launch a force call in the forward blocks of open and
    periodic P3M and of PM, as many as the short-range kernel's (no body
    overflows); none in an 8-step P3M rollout gradient, where autograd
    records the deposit (``_scatter``)."""
    for kw in (dict(distribution="plummer", dt=0.01, seed=7),
               dict(pm_boundary="periodic", pm_box=1.0, dt=0.01)):
        for kernel in ("p3m", "pm"):
            sr_kernel.launches = deposit_kernel.launches = 0
            run(SimConfig(n=4096, nsteps=8, sfreq=4, kernel=kernel,
                          pm_capacity=4096, **kw), quiet=True)
            assert deposit_kernel.launches == 12
            assert sr_kernel.launches == (12 if kernel == "p3m" else 0)
    pos, vel, mass = (torch.tensor(a, device=cuda_device)
                      for a in distributions.plummer(8192, seed=3))
    plan = pm.suggest_sr_plan(pos, mass, 64, 4, differentiable=True)
    accel = make_accel_fn("p3m", differentiable=True, grid=64, **plan)
    deposit_kernel.launches = 0
    x0, v0 = pos.clone().requires_grad_(True), vel.clone().requires_grad_(True)
    xk, _ = make_rollout_fn(accel, 0.01, 8)(x0, v0, mass)
    gx, gv = torch.autograd.grad((xk * xk).sum(), (x0, v0))
    assert deposit_kernel.launches == 0
    assert bool(torch.isfinite(gx).all() and torch.isfinite(gv).all())
    with torch.no_grad():
        accel(x0, mass)
    assert deposit_kernel.launches == 1


def _far_field_args(kind, n, device, n_t=0):
    """The solver's far-field inputs at a state of ``_deposit_state``:
    sources, their in-box masses, the robust box; targets (the sources, or
    ``n_t`` spread a quarter span past them, some outside the box), their
    in-box mask and a random ``acc``."""
    pos, mass = _deposit_state(kind, n, device)
    lo_box, hi_box = pm._robust_box(pos, mass)
    m_in = mass * pm._inside(pos, lo_box, hi_box)
    tgt = pos
    if n_t:
        g = torch.Generator(device=device).manual_seed(3)
        lo, hi = pos.amin(dim=1, keepdim=True), pos.amax(dim=1, keepdim=True)
        u = torch.rand((3, n_t), generator=g, device=device)
        tgt = (lo - 0.25 * (hi - lo)) + 1.5 * (hi - lo) * u
    in_tgt = pm._inside(tgt, lo_box, hi_box)
    acc = torch.randn(tgt.shape, generator=torch.Generator(
        device=device).manual_seed(5), device=device)
    return pos, mass, m_in, lo_box, hi_box, tgt, in_tgt, acc


@pytest.mark.parametrize("kind,n,n_t", [("uniform", 1048576, 0),
                                        ("plummer", 262144, 0),
                                        ("uniform", 300001, 77777),
                                        ("plummer", 262144, 1000003)])
def test_far_field_kernels_match_plain(cuda_device, kind, n, n_t):
    """The moments kernel's table within one float32 ulp of
    ``moments_plain``'s (both sum in float64, in other orders); the target
    kernel bit for bit the chain's (``monopoles_plain``, PyTorch's own
    kernels) given that table, with distinct targets too; two calls of each
    bit for bit."""
    pos, mass, m_in, lo_box, hi_box, tgt, in_tgt, acc = _far_field_args(
        kind, n, cuda_device, n_t)
    before = far_field_kernel.launches
    table = far_field_kernel.moments(pos, mass, m_in, lo_box, hi_box)
    again = far_field_kernel.moments(pos, mass, m_in, lo_box, hi_box)
    plain = far_field_kernel.moments_plain(pos, mass, m_in, lo_box, hi_box)
    assert torch.equal(table, again)
    ulp = torch.tensor(np.spacing(plain.abs().cpu().numpy()),
                       device=cuda_device)
    assert bool(((table - plain).abs() <= ulp).all()), (table, plain)
    got = far_field_kernel.monopoles(tgt, table, acc, in_tgt)
    assert torch.equal(got, far_field_kernel.monopoles(tgt, table, acc,
                                                       in_tgt))
    assert far_field_kernel.launches == before + 2
    assert torch.equal(got, far_field_kernel.monopoles_plain(tgt, table, acc,
                                                             in_tgt))
    if kind == "uniform":  # every source inside: the octants are empty
        assert bool((table[1:] == 0).all())
    else:
        assert float(table[1:, 0].sum()) > 0


def test_far_field_kernel_non_finite(cuda_device):
    """A non-finite position makes the whole table NaN, and every target's
    far field with it, as in the chain."""
    pos, mass, m_in, lo_box, hi_box, tgt, in_tgt, acc = _far_field_args(
        "plummer", 65536, cuda_device)
    pos = pos.clone()
    pos[1, 123] = float("nan")
    table = far_field_kernel.moments(pos, mass, m_in, lo_box, hi_box)
    assert bool(table.isnan().all())
    got = far_field_kernel.monopoles(pos, table, acc, in_tgt)
    assert not bool(torch.isfinite(got).any())


@pytest.mark.parametrize("kernel", ["pm", "p3m"])
def test_far_field_kernels_a_force_call(cuda_device, monkeypatch, kernel):
    """One target-kernel launch a force call of plain PM and open P3M on the
    card (none periodic, none under autograd); at the uniform N=1048576
    state, where every body lies inside the box, the force call equals the
    nine-call chain's bit for bit."""
    cfg = SimConfig(n=1048576, nsteps=4, sfreq=4, kernel=kernel, dt=0.001,
                    pm_capacity=16384)
    runner = _DeviceRunner(cfg)
    runner.prepare()
    try:
        st = runner.state
        before = far_field_kernel.launches
        a = runner.accel_fn(st.pos, st.mass)
        assert far_field_kernel.launches == before + 1
        monkeypatch.setattr(pm, "_hand_far_field", lambda *t: False)
        chain = runner.accel_fn(st.pos, st.mass)
        torch.cuda.synchronize()
        assert far_field_kernel.launches == before + 1
    finally:
        runner.finish()
    assert torch.equal(a, chain)
    far_field_kernel.launches = 0
    run(SimConfig(n=4096, nsteps=8, sfreq=4, kernel=kernel, pm_capacity=4096,
                  pm_boundary="periodic", pm_box=1.0, dt=0.01), quiet=True)
    assert far_field_kernel.launches == 0
    pos, vel, mass = (torch.tensor(x, device=cuda_device)
                      for x in distributions.plummer(4096, seed=3))
    p = pos.clone().requires_grad_(True)
    acc = pm.accelerations(p, mass, 32, 4 if kernel == "p3m" else 0,
                           differentiable=kernel == "p3m",
                           **(pm.suggest_sr_plan(pos, mass, 32, 4,
                                                 differentiable=True)
                              if kernel == "p3m" else {}))
    torch.autograd.grad(acc.square().sum(), p)
    assert far_field_kernel.launches == 0
