"""The port's main path on the CPU: sample blocks against the JAX package's,
the golden kinetic-energy traces of the compiled C++ reference through the
port's ``run``, the facade and the CLI.

The golden traces are compared as %.5g strings, the reference's printed
precision.  The 5-step blocks agree with JAX's to fp32 summation error
(pos/vel rtol 1e-5, kinetic energy rel 1e-6).
"""

import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.models.gravity import make_accel_fn as jax_accel
from nbody_tpu.models.gravity import make_block_fn as jax_block
from nbody_tpu.state import ParticleState as JaxState
from nbody_tpu_torch import Simulation, SimConfig, run
from nbody_tpu_torch.__main__ import main
from nbody_tpu_torch.models.gravity import (
    euler_step,
    kinetic_energy,
    make_accel_fn,
    make_block_fn,
)
from nbody_tpu_torch.state import from_numpy
from nbody_tpu_torch.utils.reporting import parse_trace

from .util import parse_golden_trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeded_state(n, seed):
    """One state made by numpy from a seed, as (JAX state, port state)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n), dtype=np.float32)
    vel = ((rng.random((3, n), dtype=np.float32) - 0.5) * 2e-3).astype(np.float32)
    mass = (np.float32(n) * rng.random(n, dtype=np.float32)).astype(np.float32)
    jst = JaxState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                   mass=jnp.asarray(mass), n=n)
    return jst, from_numpy(pos, vel, mass, n, device="cpu")


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
@pytest.mark.parametrize("kernel", ["naive", "pallas_sym", "pallas"])
def test_block_matches_jax(integrator, kernel):
    jst, st = _seeded_state(256, 7)
    j_new, j_ke = jax_block(jax_accel("naive"), 0.1, 5,
                            integrator=integrator)(jst)
    opts = {"tile_i": 128} if kernel == "pallas_sym" else {}
    new, ke = make_block_fn(make_accel_fn(kernel, **opts), 0.1, 5,
                            integrator=integrator)(st)
    assert ke.dim() == 0 and ke.dtype == torch.float32
    np.testing.assert_allclose(new.pos.numpy(), np.asarray(j_new.pos),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(new.vel.numpy(), np.asarray(j_new.vel),
                               rtol=1e-5, atol=1e-9)
    assert float(ke) == pytest.approx(float(j_ke), rel=1e-6)
    # the block leaves its input untouched (the warm-up relies on it)
    assert np.array_equal(st.pos.numpy(), np.asarray(jst.pos))


def test_block_equals_stepwise():
    _, st = _seeded_state(128, 8)
    accel = make_accel_fn("naive")
    blk, ke = make_block_fn(accel, 0.1, 5)(st)
    s = st
    for _ in range(5):
        s = euler_step(s, accel, 0.1)
    assert torch.equal(blk.pos, s.pos) and torch.equal(blk.vel, s.vel)
    assert float(ke) == float(kinetic_energy(s))


def _trace_matches(golden_dir, fname, cfg):
    golden = parse_golden_trace(os.path.join(golden_dir, fname))
    result = run(cfg, quiet=True)
    assert result.device == "cpu"
    got = [(s, f"{ke:.5g}") for s, ke in result.kenergy_trace]
    assert got == golden


@pytest.mark.parametrize("n,steps,fname", [
    (128, 50, "ver0_n128_s50.txt"),
    (256, 100, "ver0_n256_s100.txt"),
    (1024, 200, "ver0_n1024_s200.txt"),
    (2000, 50, "ver0_n2000_s50.txt"),
])
def test_golden_trace_naive(golden_dir, n, steps, fname):
    _trace_matches(golden_dir, fname, SimConfig(
        n=n, nsteps=steps, kernel="naive", platform="cpu"))


@pytest.mark.parametrize("kernel", ["pallas_sym", "pallas", "auto"])
def test_golden_trace_kernels(golden_dir, kernel):
    _trace_matches(golden_dir, "ver0_n256_s100.txt", SimConfig(
        n=256, nsteps=100, kernel=kernel, tile_i=128, platform="cpu"))


def test_run_table_and_stats():
    buf = io.StringIO()
    res = run(SimConfig(n=64, nsteps=250, sfreq=50, platform="cpu"), out=buf)
    text = buf.getvalue()
    assert text.startswith(" nPart = 64; nSteps = 250; dt = 0.1\n")
    assert [s for s, _ in parse_trace(text)] == [50, 100, 150, 200, 250]
    assert len(res.samples) == 5
    gfs = [g for *_, g in res.samples[2:]]
    assert res.av == pytest.approx(np.mean(gfs), rel=1e-9)
    assert res.dev == pytest.approx(np.std(gfs), rel=1e-6, abs=1e-9)
    assert "# Average Perfomance : " in text
    # a trailing partial block runs but is not sampled (as in the reference)
    res = run(SimConfig(n=64, nsteps=70, platform="cpu"), quiet=True)
    assert [s for s, _ in res.kenergy_trace] == [50]
    assert np.isnan(res.av) and np.isnan(res.dev)


def test_simulation_facade(capsys):
    sim = Simulation(SimConfig(n=64, nsteps=50))
    sim.set_devices(1)  # the reference's cpu selector
    sim.set_thread_dim0(32)
    sim.set_number_of_steps(100)
    sim.init_mpi()
    res = sim.start()
    assert sim.config.platform == "cpu" and sim.config.tile_i == 32
    assert [s for s, _ in res.kenergy_trace] == [50, 100]
    out = capsys.readouterr().out
    assert out.startswith("===============================\n Initialize Gravity")
    assert out.count("Initialize Gravity Simulation") == 1


def test_cli_in_process(tmp_path, capsys):
    out_json = tmp_path / "r.json"
    assert main(["64", "50", "cpu", "--json", str(out_json)]) == 0
    text = capsys.readouterr().out
    assert "\ncpu\n" in text and " nPart = 64; nSteps = 50" in text
    data = json.loads(out_json.read_text())
    assert [s["step"] for s in data["samples"]] == [50]
    assert data["device"] == "cpu"


@pytest.mark.parametrize("argv,match", [
    (["--pm-box", "1.0"], "--pm-box only applies to --pm-boundary periodic"),
    (["--checkpoint-every", "2"], "queue 1 item 12"),
    (["--autotune"], "queue 1 item 12"),
    (["--precision", "bf16", "--shards", "4", "--comm", "rdma"],
     "--comm rdma runs fp32"),
    (["--save-state", "state.npz"], "queue 1 item 12"),
])
def test_cli_refuses_unported(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        main(["64", "50", "--platform", "cpu", *argv])
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_cli_interpret_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        main(["64", "50", "--platform", "cpu", "--interpret"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "What is not ported" in err and "--platform cpu" in err
    assert "unrecognized arguments" not in err


def test_cli_list_devices(capsys):
    assert main(["--list-devices"]) == 0
    lines = capsys.readouterr().out.splitlines()
    cuda = [ln for ln in lines if ": cuda " in ln]
    assert len(cuda) == torch.cuda.device_count()
    assert lines[-1].startswith("0: cpu ") and len(lines) == len(cuda) + 1


def test_cli_profile_dir(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert main(["64", "100", "--platform", "cpu", "--profile-dir",
                 str(prof)]) == 0
    # The profiler watches the blocks and changes nothing they compute.
    ref = run(SimConfig(n=64, nsteps=100, platform="cpu"), quiet=True)
    assert parse_trace(capsys.readouterr().out) == [
        (s, f"{ke:.5g}") for s, ke in ref.kenergy_trace]
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


def test_debug_nans(capsys):
    # A finite run passes the check; a state that turns non-finite raises.
    assert main(["64", "50", "--platform", "cpu", "--debug-nans"]) == 0
    capsys.readouterr()
    cfg = SimConfig(n=64, nsteps=100, platform="cpu", debug_nans=True,
                    dt=float("inf"))
    with pytest.raises(FloatingPointError, match="non-finite position"):
        run(cfg, quiet=True)
    cfg.debug_nans = False
    res = run(cfg, quiet=True)  # without the check the run goes on
    assert not all(np.isfinite(ke) for _, ke in res.kenergy_trace)


def test_cli_subprocess_golden(golden_dir):
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch", "128", "50", "--platform",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert parse_trace(proc.stdout) == parse_golden_trace(
        os.path.join(golden_dir, "ver0_n128_s50.txt"))
    assert "# Number Threads     : 1" in proc.stdout
