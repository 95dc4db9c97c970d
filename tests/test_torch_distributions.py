"""The port's initial-condition families and ``--energy-check`` against the
JAX package's.

The families are host numpy generators, copied, so their arrays must equal
the JAX package's bit for bit.  The potential energy is a plain chunked
sweep in both packages: 1e-5 relative between them at N=2000 (fp32 sums in
other orders).  The Plummer energy check is tests/test_distributions.py's
run through the port on the CPU: drift below 1e-4, and E0 within 1e-5
relative of the JAX package's.
"""

import io
import json

import numpy as np
import pytest
import torch

from nbody_tpu.config import SimConfig as JaxConfig
from nbody_tpu.init import make_state as jax_make_state
from nbody_tpu.models import distributions as jax_dist
from nbody_tpu.models.gravity import kinetic_energy as jax_ke
from nbody_tpu.models.gravity import potential_energy as jax_pe
from nbody_tpu.simulation import run as jax_run
from nbody_tpu_torch import SimConfig, run
from nbody_tpu_torch.__main__ import main
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.models.gravity import potential_energy
from nbody_tpu_torch.simulation import _DeviceRunner

torch.set_num_threads(2)

PLUMMER = dict(n=512, nsteps=100, dt=0.01, distribution="plummer", seed=7,
               integrator="leapfrog", energy_check=True)


@pytest.mark.parametrize("name,n,seed", [
    ("reference", 64, 42), ("reference", 64, 43), ("plummer", 4096, 1),
    ("plummer", 333, 7), ("cold_sphere", 1000, 3),
])
def test_arrays_equal_jax(name, n, seed):
    ours = distributions.make_arrays(name, n, seed=seed)
    theirs = jax_dist.make_arrays(name, n, seed=seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert np.array_equal(a, b)


def test_unknown_distribution():
    with pytest.raises(KeyError, match="gaussian"):
        distributions.make_arrays("gaussian", 10)
    with pytest.raises(ValueError, match="unknown distribution"):
        SimConfig(distribution="gaussian")


@pytest.mark.parametrize("name", ["plummer", "cold_sphere"])
def test_make_state_pads_the_family(name):
    st = make_state(100, pad_multiple=128, distribution=name, seed=5,
                    device="cpu")
    pos, vel, mass = distributions.make_arrays(name, 100, seed=5)
    assert st.n == 100 and st.pos.shape == (3, 128)
    assert np.array_equal(st.pos[:, :100].numpy(), pos)
    assert np.array_equal(st.vel[:, :100].numpy(), vel)
    assert np.array_equal(st.mass[:100].numpy(), mass)
    assert torch.all(st.mass[100:] == 0)


def test_potential_energy_matches_jax():
    st = make_state(2000, device="cpu")
    ours = float(potential_energy(st))
    theirs = float(jax_pe(jax_make_state(2000)))
    assert abs(ours - theirs) <= 1e-5 * abs(theirs)
    # zero-mass padding adds nothing
    padded = float(potential_energy(make_state(2000, pad_multiple=2048,
                                               device="cpu")))
    assert abs(padded - ours) <= 1e-6 * abs(ours)
    # chunking only regroups the sum
    assert abs(float(potential_energy(st, chunk=300)) - ours) <= 1e-6 * abs(ours)


def test_plummer_energy_check_matches_jax():
    cfg = SimConfig(platform="cpu", **PLUMMER)
    runner = _DeviceRunner(cfg)
    runner.prepare()
    e0 = runner.total_energy()
    js = jax_make_state(512, distribution="plummer", seed=7)
    e0_jax = float(jax_ke(js)) + float(jax_pe(js))
    assert abs(e0 - e0_jax) <= 1e-5 * abs(e0_jax)

    res = run(cfg, quiet=True)
    assert res.energy_drift is not None
    assert res.energy_drift < 1e-4  # bound system, symplectic integrator
    assert res.to_dict()["energy_drift"] == res.energy_drift
    want = jax_run(JaxConfig(kernel="naive", platform="cpu", **PLUMMER),
                   quiet=True)
    assert res.energy_drift == pytest.approx(want.energy_drift, rel=0.5)


def test_energy_check_line_and_json(tmp_path):
    out = io.StringIO()
    res = run(SimConfig(n=64, nsteps=50, platform="cpu", energy_check=True),
              out=out)
    text = out.getvalue()
    footer = text.index("# Average Perfomance")
    line = [ln for ln in text.splitlines() if ln.startswith("# Energy drift")]
    assert len(line) == 1 and text.index(line[0]) > footer
    assert line[0].startswith(f"# Energy drift |dE/E|: {res.energy_drift:.3e} (E0=")
    assert run(SimConfig(n=64, nsteps=50, platform="cpu"),
               quiet=True).energy_drift is None

    path = tmp_path / "r.json"
    assert main(["64", "50", "--platform", "cpu", "--energy-check",
                 "--distribution", "cold_sphere", "--json", str(path)]) == 0
    data = json.loads(path.read_text())
    assert data["energy_drift"] is not None and data["energy_drift"] >= 0


def test_energy_is_outside_the_trace():
    # The energy check prints one more line and changes no kinetic energy.
    a = run(SimConfig(n=128, nsteps=50, platform="cpu"), quiet=True)
    b = run(SimConfig(n=128, nsteps=50, platform="cpu", energy_check=True),
            quiet=True)
    assert a.kenergy_trace == b.kenergy_trace
