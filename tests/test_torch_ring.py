"""The plain versions of the sharded modes' two kernels on the CPU, against
the JAX package's Pallas kernels in interpret mode, and the two repairs that
the sharded path needs.

* ``sym_kernel.accelerations_two_sided`` (``csrc/two_sided.cu`` on a card)
  against ``nbody_tpu.ops.pallas_sym.accelerations_two_sided(...,
  interpret=True)``: both sides, zero-mass padding exactly 0;
* ``parallel.ring_kernel.ring_accelerations`` (``csrc/ring.cu`` on a card)
  against ``nbody_tpu.parallel.ring_kernel.ring_accelerations`` under
  ``shard_map`` in interpret mode, as tests/test_ring_kernel.py runs it;
* the registry's ``auto`` between form, and the state constructors'
  default device (the card, raising without one).

Tolerance: relative norm 1e-5, fp32 summation in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nbody_tpu.ops.pallas_sym import accelerations_two_sided as jax_two_sided
from nbody_tpu.parallel.decompose import shard_map
from nbody_tpu.parallel.mesh import AXIS
from nbody_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nbody_tpu.parallel.ring_kernel import ring_accelerations as jax_ring
from nbody_tpu_torch.init import make_state
from nbody_tpu_torch.ops import registry, sym_kernel, tiled_kernel
from nbody_tpu_torch.parallel import ring_kernel
from nbody_tpu_torch.state import from_numpy, pad_state

torch.set_num_threads(2)

REL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _bodies(n_real, n, seed):
    """(pos (3,n), mass (n,)) fp32 made by numpy, zero-mass padded to n on
    the padding's far-away line."""
    rng = np.random.default_rng(seed)
    pos = rng.random((3, n_real), dtype=np.float32)
    mass = (np.float32(n_real) * rng.random(n_real, dtype=np.float32))
    st = pad_state(pos, np.zeros_like(pos), mass.astype(np.float32), n,
                   device="cpu")
    return st.pos.numpy(), st.mass.numpy()


@pytest.mark.parametrize("nt_real,nt,ns_real,ns,block", [
    (256, 256, 250, 256, 64),  # Nt = Ns, padded sources
    (100, 128, 300, 384, 64),  # Nt != Ns, both padded
    (512, 512, 512, 512, 128),  # the port's default block
])
def test_two_sided_plain_matches_jax(nt_real, nt, ns_real, ns, block):
    pt, mt = _bodies(nt_real, nt, 1)
    ps, ms = _bodies(ns_real, ns, 2)
    j_t, j_s = jax_two_sided(jnp.asarray(pt), jnp.asarray(mt), jnp.asarray(ps),
                             jnp.asarray(ms), block=block, interpret=True)
    t, s = sym_kernel.accelerations_two_sided(
        *(torch.from_numpy(a) for a in (pt, mt, ps, ms)), block=block)
    assert t.shape == (3, nt) and s.shape == (3, ns)
    assert _rel(t[:, :nt_real], np.asarray(j_t)[:, :nt_real]) <= REL
    assert _rel(s[:, :ns_real], np.asarray(j_s)[:, :ns_real]) <= REL
    assert torch.all(t[:, nt_real:] == 0) and torch.all(s[:, ns_real:] == 0)


def test_two_sided_is_action_and_reaction():
    """Both sides of one sweep equal the one-sided forces between the two
    sets, and the total momentum change of the pair sums to zero."""
    pt, mt = _bodies(128, 128, 3)
    ps, ms = _bodies(256, 256, 4)
    t_pt, t_mt, t_ps, t_ms = (torch.from_numpy(a) for a in (pt, mt, ps, ms))
    t, s = sym_kernel.accelerations_two_sided(t_pt, t_mt, t_ps, t_ms)
    one_t = tiled_kernel.accelerations_between_plain(t_pt, t_ps, t_ms)
    one_s = tiled_kernel.accelerations_between_plain(t_ps, t_pt, t_mt)
    assert _rel(t, one_t) <= REL and _rel(s, one_s) <= REL
    momentum = (t * t_mt).sum(dim=1) + (s * t_ms).sum(dim=1)
    assert float(momentum.abs().max()) <= 1e-6 * float((t * t_mt).abs().sum())


def test_two_sided_refuses_ragged_blocks():
    pt, mt = _bodies(100, 100, 5)
    args = [torch.from_numpy(a) for a in (pt, mt, pt, mt)]
    with pytest.raises(ValueError, match="must be divisible by block=64"):
        sym_kernel.accelerations_two_sided(*args, block=64)


@pytest.mark.parametrize("k,n", [(3, 384), (8, 512)])
def test_ring_plain_matches_jax(k, n):
    pos, mass = _bodies(n, n, 6 + k)
    mesh = jax_make_mesh(k)

    def accel(pos_l, mass_l):
        return jax_ring(pos_l, mass_l, k, tile_i=32, tile_j=16, interpret=True)

    sm = shard_map(accel, mesh=mesh, in_specs=(P(None, AXIS), P(AXIS)),
                   out_specs=P(None, AXIS), check_vma=False)
    want = np.asarray(jax.jit(sm)(jnp.asarray(pos), jnp.asarray(mass)))
    nl = n // k
    got = ring_kernel.ring_accelerations(
        [torch.from_numpy(pos[:, s * nl:(s + 1) * nl].copy()) for s in range(k)],
        [torch.from_numpy(mass[s * nl:(s + 1) * nl].copy()) for s in range(k)],
    )
    assert len(got) == k and all(a.shape == (3, nl) for a in got)
    assert _rel(torch.cat(got, dim=1), want) <= REL


def test_ring_refuses_shards_on_two_devices():
    pos = [torch.zeros(3, 8), torch.zeros(3, 8, device="meta")]
    mass = [torch.zeros(8), torch.zeros(8, device="meta")]
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        ring_kernel.ring_accelerations(pos, mass)
    with pytest.raises(ValueError, match="must have shape"):
        ring_kernel.ring_accelerations([torch.zeros(3, 8), torch.zeros(3, 4)],
                                       [torch.zeros(8), torch.zeros(4)])


def test_registry_auto_between_is_the_tiled_kernel():
    # As JAX's _lookup, which resolves `auto` first: the sharded allgather
    # and ring modes of `auto` take the tiled kernel's between form.
    assert registry.get_between("auto") is tiled_kernel.accelerations_between
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get_between("bogus")


def test_state_constructors_default_to_the_card():
    pos = np.zeros((3, 4), np.float32)
    mass = np.ones(4, np.float32)
    calls = [lambda: make_state(8), lambda: pad_state(pos, pos, mass, 8),
             lambda: from_numpy(pos, pos, mass, 4)]
    for call in calls:
        if torch.cuda.is_available():
            assert call().pos.device.type == "cuda"
        else:  # no silent fallback to the CPU, as SimConfig.device()
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    assert make_state(8, device="cpu").pos.device.type == "cpu"
