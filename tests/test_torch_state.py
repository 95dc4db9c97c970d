"""The PyTorch port's host substrate against the JAX package: the RNG
fixtures, the initial conditions, padding and the carry-across of a state,
the configuration, the reference's table, and that the port imports no JAX.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu.init as jax_init
import nbody_tpu.models.distributions as jax_dist
import nbody_tpu.utils.reporting as jax_reporting
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_state, reference_init_arrays
from nbody_tpu_torch.state import from_numpy, pad_state, round_up, to_host
from nbody_tpu_torch.utils import reporting
from nbody_tpu_torch.utils.mt19937 import (
    MT19937,
    generate_canonical_f32,
    uniform_real_f32,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture(golden_dir, name, dtype):
    return np.fromfile(os.path.join(golden_dir, name), dtype=dtype)


@pytest.mark.parametrize("name,draw", [
    ("mt19937_42_raw.u32", lambda k: MT19937(42).raw(k)),
    ("mt19937_42_u01.f32", lambda k: uniform_real_f32(42, k, 0.0, 1.0)),
    ("mt19937_42_u11.f32", lambda k: uniform_real_f32(42, k, -1.0, 1.0)),
])
def test_mt19937_fixtures_bit_exact(golden_dir, name, draw):
    dtype = np.uint32 if name.endswith(".u32") else np.float32
    golden = _fixture(golden_dir, name, dtype)
    got = draw(len(golden))
    assert got.dtype == dtype
    assert np.array_equal(got, golden)


def test_mt19937_chunked_reads_and_clamp(golden_dir):
    golden = _fixture(golden_dir, "mt19937_42_raw.u32", np.uint32)
    gen = MT19937(42)
    got = np.concatenate([gen.raw(1), gen.raw(623), gen.raw(624), gen.raw(1000)])
    assert np.array_equal(got, golden[: len(got)])
    raw = np.array([2**32 - 1, 2**32 - 129, 0], dtype=np.uint32)
    canon = generate_canonical_f32(raw)
    assert canon[0] == np.nextafter(np.float32(1.0), np.float32(0.0))
    assert canon[1] < 1.0 and canon[2] == 0.0


@pytest.mark.parametrize("n", [1, 100, 2000])
def test_reference_init_bit_equal_to_jax(n):
    for ours, theirs in zip(reference_init_arrays(n),
                            jax_init.reference_init_arrays(n)):
        assert ours.dtype == np.float32
        assert np.array_equal(ours, theirs)


def test_other_seed_matches_jax_reference_distribution():
    for ours, theirs in zip(reference_init_arrays(300, seed=7),
                            jax_dist.reference(300, seed=7)):
        assert np.array_equal(ours, theirs)


def test_pad_state_matches_jax_and_round_trips():
    st_jax = jax_init.make_state(100, pad_multiple=64)
    ours = make_state(100, pad_multiple=64, device="cpu")
    assert ours.n == 100 and ours.n_padded == 128 == round_up(100, 64)
    for name in ("pos", "vel", "mass"):
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(st_jax, name)))
    assert torch.all(ours.mass[100:] == 0) and torch.all(ours.vel[:, 100:] == 0)
    # carry-across: the JAX state's arrays, as numpy, become the port's state
    carried = from_numpy(np.asarray(st_jax.pos), np.asarray(st_jax.vel),
                         np.asarray(st_jax.mass), st_jax.n, device="cpu")
    host = to_host(carried)
    pos, vel, mass = reference_init_arrays(100)
    assert host["n"] == 100
    assert np.array_equal(host["pos"], pos) and np.array_equal(host["vel"], vel)
    assert np.array_equal(host["mass"], mass)
    again = pad_state(host["pos"], host["vel"], host["mass"], 128,
                      device="cpu")
    assert torch.equal(again.pos, carried.pos) and torch.equal(again.mass, carried.mass)


def test_make_state_refuses_unported_distribution():
    # Every family of the JAX package is ported; a name it does not have
    # is refused by name.
    with pytest.raises(KeyError, match="unknown distribution 'gaussian'"):
        make_state(10, distribution="gaussian", device="cpu")


@pytest.mark.parametrize("kw,exc,match", [
    (dict(precision="bf16", kernel="pm"), ValueError, "fp32-only"),
    (dict(precision="ref64"), NotImplementedError, "queue 1 item 12"),
    (dict(kernel="p3m", pm_boundary="periodic"), ValueError,
     "requires --pm-box"),
    (dict(kernel="pm", pm_box=1.0), ValueError, "only applies"),
    (dict(kernel="bogus"), ValueError, "unknown kernel"),
    (dict(platform="tpu"), ValueError, "unknown platform"),
    (dict(n=0), ValueError, "n must be"),
    (dict(shards=0), ValueError, "shards must be"),
    (dict(shards=2, fused=True), ValueError, "--fused"),
    (dict(comm="mpi"), ValueError, "unknown comm"),
    (dict(shards=2, kernel="p3m"), NotImplementedError, "queue 1 item 11"),
    (dict(shards=2, kernel="pm", comm="ring"), ValueError,
     "only --comm allgather"),
])
def test_config_refuses(kw, exc, match):
    with pytest.raises(exc, match=match):
        SimConfig(**kw)


def test_config_padding_and_device():
    # On CUDA, auto pads to the pair-symmetric block (2000 -> 2048, as on
    # the TPU); on the CPU it resolves to naive, which needs no padding.
    assert SimConfig().resolved_kernel() == "pallas_sym"
    assert SimConfig().pad_multiple() == 128
    assert round_up(2000, SimConfig().pad_multiple()) == 2048
    assert SimConfig(platform="cpu").resolved_kernel() == "naive"
    assert SimConfig(platform="cpu").pad_multiple() == 1
    assert SimConfig(kernel="pallas").pad_multiple() == 1
    assert SimConfig(kernel="pallas_sym", tile_i=64).pad_multiple() == 64
    assert SimConfig(platform="cpu").device() == torch.device("cpu")
    if torch.cuda.is_available():
        assert SimConfig().device().type == "cuda"
    else:  # no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SimConfig().device()


def test_table_byte_equal_to_jax():
    nan = float("nan")
    assert reporting.banner() == jax_reporting.banner()
    assert reporting.header(2000, 500, 0.1) == jax_reporting.header(2000, 500, 0.1)
    for row in [(50, 5.0, 0.1432, 1.618, 3.5858), (500, 50.0, 571.53, 1e-4, 1e6)]:
        assert reporting.stats_row(*row) == jax_reporting.stats_row(*row)
    for foot in [(1, 16.282, 3.5547, 0.053287), (1, 0.5, nan, nan)]:
        assert reporting.footer(*foot) == jax_reporting.footer(*foot)
    assert "Perfomance : -nan +- -nan" in reporting.footer(1, 0.5, nan, nan)
    text = reporting.header(1, 1, 0.1) + "\n" + reporting.stats_row(
        50, 5.0, 0.1432, 1.0, 2.0)
    assert reporting.parse_trace(text) == jax_reporting.parse_trace(text)


def test_import_leaves_jax_out():
    code = ("import sys, nbody_tpu_torch, nbody_tpu_torch.__main__; "
            "import nbody_tpu_torch.ops.registry, nbody_tpu_torch.ops.pm, "
            "nbody_tpu_torch.ops.sr_kernel, nbody_tpu_torch.parallel.decompose, "
            "nbody_tpu_torch.parallel.ring_kernel; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'nbody_tpu.'))); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_state_dtype_matches_jax():
    st = make_state(16, device="cpu")
    assert st.pos.dtype == st.vel.dtype == st.mass.dtype == torch.float32
    assert np.asarray(jax_init.make_state(16).pos).dtype == jnp.float32
