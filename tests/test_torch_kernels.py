"""The port's force kernels against the JAX package's.

On the CPU every wrapper runs its plain PyTorch version (the CUDA kernels
cannot run here), so these tests hold the plain versions against the JAX
functions they port: ``naive`` against JAX ``naive``, the plain tiled sweep
against ``pallas_kernel.accelerations_between(interpret=True)`` and the
plain pair-symmetric sweep against ``pallas_sym.accelerations(interpret=
True)``.  Inputs are made by numpy from a seed and fed to both packages.
The kernels themselves are held against these plain versions on a card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: the sweeps sum in other orders than the Pallas kernels, so they
agree to fp32 summation error, stated as a relative-norm bound (5e-6 for
the kernels, 1e-6 for the naive broadcast, which differs only in the order
of its one reduction).  The tiled sweep's inverse cube on the card
(``nbt::rsqrt_cube``: rsqrt.approx, one Newton step) is emulated here at
the approximation's documented worst error, and held to 1e-6 of the IEEE
plain sweep.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops import naive as jax_naive
from nbody_tpu.ops import pallas_kernel as jax_pallas
from nbody_tpu.ops import pallas_sym as jax_sym
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.ops import mxu_kernel, naive, registry, sym_kernel, tiled_kernel
from nbody_tpu_torch.types import G_NEWTON, SOFTENING_SQUARED
from nbody_tpu_torch.utils import build

torch.set_num_threads(2)


def _particles(n, seed, pad_to=None):
    """Random positions in the unit cube and reference-scale masses, with
    zero-mass padding on the far diagonal up to ``pad_to``."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    if pad_to and pad_to > n:
        far = 1.0e6 + np.arange(pad_to - n, dtype=np.float32)
        pos = np.concatenate([pos, np.tile(far, (3, 1))], axis=1)
        mass = np.concatenate([mass, np.zeros(pad_to - n, np.float32)])
    return pos, mass


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nt,ns,seed", [(256, 256, 0), (200, 333, 1)])
def test_naive_matches_jax_naive(nt, ns, seed):
    pt, _ = _particles(nt, seed)
    ps, ms = _particles(ns, seed + 100)
    ours = naive.accelerations_between(_t(pt), _t(ps), _t(ms), chunk=64)
    ref = jax_naive.accelerations_between(jnp.asarray(pt), jnp.asarray(ps),
                                          jnp.asarray(ms))
    assert ours.shape == (3, nt) and ours.dtype == torch.float32
    assert _rel(ours.numpy(), ref) <= 1e-6


def test_plain_tiled_matches_pallas_interpret():
    pt, _ = _particles(256, 2)
    ps, ms = _particles(384, 3)
    ref = jax_pallas.accelerations_between(
        jnp.asarray(pt), jnp.asarray(ps), jnp.asarray(ms),
        tile_i=128, tile_j=128, interpret=True)
    plain = tiled_kernel.accelerations_between_plain(_t(pt), _t(ps), _t(ms))
    # The wrapper on CPU tensors is the plain version, and launches nothing.
    before = tiled_kernel.launches
    wrapped = tiled_kernel.accelerations_between(_t(pt), _t(ps), _t(ms),
                                                 tile_i=128, tile_j=128)
    assert tiled_kernel.launches == before
    assert torch.equal(wrapped, plain)
    assert plain.shape == (3, 256)
    assert _rel(plain.numpy(), ref) <= 5e-6


@pytest.mark.parametrize("n", [256, 512])
def test_plain_sym_matches_pallas_sym_interpret(n):
    pos, mass = _particles(n, 10 + n)
    ref = jax_sym.accelerations(jnp.asarray(pos), jnp.asarray(mass),
                                block=128, interpret=True)
    plain = sym_kernel.accelerations_plain(_t(pos), _t(mass), block=128)
    before = sym_kernel.launches
    wrapped = sym_kernel.accelerations(_t(pos), _t(mass), block=128)
    assert sym_kernel.launches == before
    assert torch.equal(wrapped, plain)
    assert _rel(plain.numpy(), ref) <= 5e-6


def rsqrt_cube_emulated(d2, ulps: int) -> np.ndarray:
    """``nbt::rsqrt_cube`` (csrc/common.cuh) on the CPU, with its
    rsqrt.approx taken ``ulps`` units in the last place off the correctly
    rounded 1/sqrt (CUDA documents at most 2): the Newton step
    y * fmaf(-(0.5 d2) y, y, 1.5), then y * y * y, each fp32 operation
    rounded as the card rounds it."""
    d2 = np.asarray(d2, np.float32)
    y = (1.0 / np.sqrt(d2.astype(np.float64))).astype(np.float32)
    y = (y.view(np.int32) + np.int32(ulps)).view(np.float32)
    hy = (np.float32(0.5) * d2) * y
    y = y * (-hy.astype(np.float64) * y + 1.5).astype(np.float32)
    return (y * y) * y


@pytest.mark.parametrize("ulps", [-2, 2])
def test_rsqrt_newton_sweep_matches_ieee(ulps):
    """Kernel A's loop takes d2^{-3/2} as rsqrt and one Newton step instead
    of IEEE 1 / sqrt: at the approximation's worst error, the N=2000
    reference-IC forces stay within 1e-6 of the IEEE plain sweep, and the
    step takes out most of the approximation's own error."""
    st = make_state(2000, device="cpu")
    pos, mass = st.pos.numpy(), st.mass.numpy()
    d = pos[:, None, :] - pos[:, :, None]  # (3, targets, sources)
    d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + np.float32(SOFTENING_SQUARED)
    gm = mass * np.float32(G_NEWTON)
    plain = tiled_kernel.accelerations_between_plain(st.pos, st.pos,
                                                     st.mass).numpy()
    got = (d * (gm[None, :] * rsqrt_cube_emulated(d2, ulps))).sum(axis=2)
    y = (1.0 / np.sqrt(d2.astype(np.float64))).astype(np.float32)
    y = (y.view(np.int32) + np.int32(ulps)).view(np.float32)
    raw = (d * (gm[None, :] * ((y * y) * y))).sum(axis=2)  # no Newton step
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, plain) * 3 < _rel(raw, plain)


def test_padded_columns_exactly_zero():
    pos, mass = _particles(200, 4, pad_to=256)
    acc = sym_kernel.accelerations_plain(_t(pos), _t(mass), block=128)
    assert torch.all(acc[:, 200:] == 0.0)
    # ... and the padding changes nothing for the real particles.
    real = naive.accelerations(_t(pos[:, :200]), _t(mass[:200]))
    assert _rel(acc[:, :200].numpy(), real.numpy()) <= 5e-6
    # The tiled sweep with padded sources equals it without them.
    a_pad = tiled_kernel.accelerations_between(_t(pos[:, :200]), _t(pos),
                                               _t(mass))
    assert _rel(a_pad.numpy(), real.numpy()) <= 5e-6


def test_sym_reference_state_matches_jax_sym():
    st = make_state(2000, pad_multiple=128, device="cpu")  # 2000 -> 2048
    ref = jax_sym.accelerations(jnp.asarray(st.pos.numpy()),
                                jnp.asarray(st.mass.numpy()), block=1024,
                                interpret=True)
    ours = sym_kernel.accelerations(st.pos, st.mass)
    assert _rel(ours.numpy(), ref) <= 5e-6
    assert torch.all(ours[:, 2000:] == 0.0)


@pytest.mark.parametrize("fn,args,exc", [
    ("tiled", dict(dtype=torch.float64), TypeError),
    ("tiled", dict(transpose=True), ValueError),
    ("sym", dict(dtype=torch.float64), TypeError),
    ("sym", dict(n=200), ValueError),  # not a multiple of the block
])
def test_wrappers_check_inputs(fn, args, exc):
    n = args.get("n", 256)
    pos = torch.rand(3, n, dtype=args.get("dtype", torch.float32))
    mass = torch.rand(n, dtype=pos.dtype)
    if args.get("transpose"):
        pos = torch.rand(n, 3).t()  # (3, n) but not contiguous
    with pytest.raises(exc):
        if fn == "tiled":
            tiled_kernel.accelerations(pos, mass)
        else:
            sym_kernel.accelerations(pos, mass, block=128)


def test_registry_auto_and_names():
    assert registry.available() == ("naive", "p3m", "pallas", "pallas_mxu",
                                    "pallas_sym", "pm", "auto")
    assert registry.resolve("auto", "cpu") == "naive"
    assert registry.resolve("auto", "cuda") == "pallas_sym"
    assert registry.resolve("pallas", "cpu") == "pallas"
    assert registry.get_between("pallas_sym") is tiled_kernel.accelerations_between
    pos, mass = _particles(128, 5)
    auto = registry.get("auto")(_t(pos), _t(mass), tile_i=64)
    assert torch.equal(auto, naive.accelerations(_t(pos), _t(mass)))
    assert registry.get("pallas_mxu") is mxu_kernel.accelerations
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get("pallas_fft")


def test_sym_scratch_budget():
    # 12 N^2 / B bytes of partials: 25 MB at N=16384, B=128.
    assert sym_kernel.scratch_bytes(16384, 128) == 12 * 16384 * 16384 // 128
    assert sym_kernel.scratch_bytes(2048, 128) == 3 * 2048 * 16 * 4
    # One band holds all of them; a band of R tiles takes 12 R (2N - R B).
    assert sym_kernel.band_bytes(16384, 128, 128) == sym_kernel.scratch_bytes(
        16384, 128)
    assert sym_kernel.band_bytes(2048, 128, 1) == 12 * 128 * 31


def test_sym_bands_at_a_million():
    # N=1048576, B=128 on an 80 GB card: the partials (103 GB) take 21 bands
    # of about 400 tiles within a budget of 1/8 of the card's memory.
    n, b, budget = 1048576, 128, int(80e9 * sym_kernel.SCRATCH_SHARE)
    assert sym_kernel.scratch_bytes(n, b) > 80e9
    band = sym_kernel.sym_band(n, b, budget)
    assert sym_kernel.band_bytes(n, b, band) <= budget
    assert sym_kernel.band_bytes(n, b, band + 1) > budget
    assert -(-(n // b) // band) == 21 and 380 <= band <= 420
    # Everything fits: one band.
    assert sym_kernel.sym_band(16384, 128, budget) == 128
    # Not even one tile: a ValueError that names the tiled kernel.
    with pytest.raises(ValueError, match="--kernel pallas"):
        sym_kernel.sym_band(n, b, sym_kernel.band_bytes(n, b, 1) - 1)
    with pytest.raises(ValueError, match="--kernel pallas"):
        sym_kernel.two_sided_band(4096, n, b, 24 * n - 1)  # 24 Ns a tile
    assert sym_kernel.two_sided_band(4096, 4096, 128, 24 * 4096 * 5) == 5


@pytest.mark.parametrize("n,block,bands", [(512, 64, 3), (768, 128, 1),
                                           (768, 128, 2), (2000, 80, 7)])
def test_banded_sym_equals_one_band(n, block, bands):
    """The plain Kernel B under a tiny scratch budget sweeps its i tiles in
    bands; each row still adds its partials in column order, so the result
    equals the one-band sweep bit for bit, in both distance modes."""
    pos, mass = _particles(n, 30 + n, pad_to=n + (-n) % block)
    for dist in ("float32", "bfloat16"):
        one = sym_kernel.accelerations(_t(pos), _t(mass), block=block,
                                       dist_dtype=dist)
        budget = sym_kernel.band_bytes(pos.shape[1], block, bands)
        assert sym_kernel.sym_band(pos.shape[1], block, budget) == bands
        banded = sym_kernel.accelerations(_t(pos), _t(mass), block=block,
                                          dist_dtype=dist,
                                          scratch_budget=budget)
        assert torch.equal(banded, one)


@pytest.mark.parametrize("nt,ns,block,bands", [(512, 256, 64, 3),
                                               (256, 384, 128, 1)])
def test_banded_two_sided_equals_one_band(nt, ns, block, bands):
    pt, mt = _particles(nt, 40)
    ps, ms = _particles(ns, 41)
    args = (_t(pt), _t(mt), _t(ps), _t(ms))
    one = sym_kernel.accelerations_two_sided(*args, block=block)
    budget = 24 * bands * ns
    banded = sym_kernel.accelerations_two_sided(*args, block=block,
                                                scratch_budget=budget)
    assert all(torch.equal(a, b) for a, b in zip(banded, one))
    want_t = naive.accelerations_between(*args[:1], *args[2:])
    assert _rel(banded[0].numpy(), want_t.numpy()) <= 5e-6


def test_build_layout():
    srcs = [p.name for p in build.sources()]
    assert srcs == ["deposit.cu", "far_field.cu", "fused.cu", "mxu.cu",
                    "ring.cu", "sr.cu", "sr_vjp.cu", "sym.cu", "tiled.cu",
                    "two_sided.cu", "vjp.cu"]
    path = build.library_path()
    assert path.name == "libnbody_kernels.so"
    assert path.parent.parent == build.BUILD_DIR
    assert len(path.parent.name) == 16
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if any(a.endswith("{fail}") for a in args):
    print("error: {fail} does not compile")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").close()
"""


@pytest.mark.parametrize("fail", ["", "fused.cu"])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """One nvcc per source, then one link; a failing source raises with
    the compiler's output and leaves no library behind."""
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log),
                                     fail=fail or "never"))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="fused.cu does not compile"):
            build.build()
        assert not build.library_path().exists()
    else:
        lib, _ = build.build()
        assert lib == build.library_path() and lib.exists()
        assert build.build() == (lib, 0.0)  # built once per source hash
    calls = log.read_text().splitlines()
    compiles = sorted(c.split()[-1] for c in calls if " -c " in c)
    assert compiles == sorted(str(p) for p in build.sources())
    assert all(" ".join(build.NVCC_FLAGS) in c for c in calls if " -c " in c)
    links = [c for c in calls if "-shared" in c]
    assert len(links) == (0 if fail else 1)
    assert not [p for p in os.listdir(build.library_path().parent)
                if p.endswith((".o", ".tmp"))]
