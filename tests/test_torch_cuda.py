"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one.  The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch (the repository's conftest imports JAX, so
there it is skipped with ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: the kernels sum in other orders than the plain versions, so
they agree to fp32 summation error, bounded at 1e-5 relative norm.
"""

import os

import pytest
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.ops import sym_kernel, tiled_kernel
from nbody_tpu_torch.simulation import run
from nbody_tpu_torch.utils.reporting import parse_trace

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
