"""Particle state: structure-of-arrays fp32 tensors on one device.

The same layout as ``nbody_tpu.state``: ``pos`` (3, N), ``vel`` (3, N) and
``mass`` (N,), all fp32, plus ``n``, the number of real particles.  The
arrays may be padded beyond ``n`` with zero-mass particles, which exert
exactly zero force and carry zero kinetic energy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParticleState:
    pos: torch.Tensor  # (3, N_padded) fp32
    vel: torch.Tensor  # (3, N_padded) fp32
    mass: torch.Tensor  # (N_padded,) fp32
    n: int  # real particles

    @property
    def n_padded(self) -> int:
        return self.pos.shape[1]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def device_or_card(device=None) -> torch.device:
    """``device``, or the current CUDA card when it is None.  A missing card
    raises instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the CPU path runs only on request "
            "(--platform cpu, SimConfig(platform='cpu') or the 'cpu' "
            "device token)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def from_numpy(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray, n: int,
               device=None) -> ParticleState:
    """Wrap host arrays, such as a JAX state fetched with ``np.asarray``,
    as a state on ``device`` (None: the card).  The arrays are copied;
    padding beyond ``n`` is kept as it is."""
    device = device_or_card(device)

    def put(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=torch.float32,
                            device=device)

    return ParticleState(pos=put(pos), vel=put(vel), mass=put(mass), n=n)


def pad_state(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
              n_padded: int, device=None) -> ParticleState:
    """Pad host SoA arrays to ``n_padded`` with zero-mass particles and put
    them on ``device`` (None: the card; ``nbody_tpu.state.pad_state``).

    Padded particles sit on a far-away diagonal line so they never coincide
    with real particles."""
    n = pos.shape[1]
    if n_padded < n:
        raise ValueError(f"n_padded={n_padded} < n={n}")
    pad = n_padded - n
    if pad:
        far = 1.0e6 + np.arange(pad, dtype=np.float32)
        pos = np.concatenate([pos, np.tile(far, (3, 1))], axis=1)
        vel = np.concatenate([vel, np.zeros((3, pad), np.float32)], axis=1)
        mass = np.concatenate([mass, np.zeros(pad, np.float32)])
    return from_numpy(pos, vel, mass, n, device)


def to_host(state: ParticleState) -> dict:
    """The real (unpadded) particles as host numpy arrays."""
    return dict(
        pos=state.pos[:, : state.n].cpu().numpy(),
        vel=state.vel[:, : state.n].cpu().numpy(),
        mass=state.mass[: state.n].cpu().numpy(),
        n=state.n,
    )
