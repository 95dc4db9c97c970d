"""Initial-condition families, a copy of ``nbody_tpu.models.distributions``.

The reference has exactly one IC: per-field re-seeded uniform draws
(ver0/GSimulation.cpp:44-93), reproduced bit-exactly by init.py and kept
as the default ("reference").  The other families are the JAX package's
extensions.  All are host-side numpy, seeded deterministically, and return
(pos (3,N), vel (3,N), mass (N,)) fp32 arrays bit-equal to the JAX
package's; ``init.make_state`` moves them to the device.
"""

from __future__ import annotations

import numpy as np

from ..types import G_NEWTON


def reference(n: int, seed: int = 42):
    """The reference's initial conditions (seed fixed at 42 by its design;
    other seeds use the same draw structure)."""
    from ..init import reference_init_arrays

    return reference_init_arrays(n, seed)


def plummer(n: int, seed: int = 0, total_mass: float = 1.0e10,
            scale_radius: float = 1.0):
    """Plummer (1911) sphere in virial equilibrium: the standard stellar
    cluster model.  Positions from the analytic inverse CDF, isotropic
    velocities rejection-sampled from the local escape speed (Aarseth,
    Henon & Wielen 1974).  The default total_mass gives, with the
    reference's G, a characteristic velocity ~0.8 and crossing time ~1.2,
    so dt~0.01 resolves the dynamics well."""
    rng = np.random.default_rng(seed)
    m = np.full(n, total_mass / n, np.float32)

    # radius: r = a / sqrt(u^(-2/3) - 1)
    u = rng.random(n)
    r = scale_radius / np.sqrt(np.maximum(u, 1e-12) ** (-2.0 / 3.0) - 1.0)
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh**2)
    phi = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [r * sinth * np.cos(phi), r * sinth * np.sin(phi), r * costh]
    ).astype(np.float32)

    # speed: q = v/v_esc with density q^2 (1-q^2)^(7/2), von Neumann sampling
    q = np.empty(n)
    need = np.ones(n, bool)
    while need.any():
        k = int(need.sum())
        x = rng.random(k)
        y = rng.random(k) * 0.1
        ok = y < x * x * (1 - x * x) ** 3.5
        idx = np.flatnonzero(need)[ok]
        q[idx] = x[ok]
        need[idx] = False
    v_esc = np.sqrt(2.0 * G_NEWTON * total_mass) * (
        r * r + scale_radius * scale_radius
    ) ** -0.25
    speed = q * v_esc
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh**2)
    phi = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack(
        [speed * sinth * np.cos(phi), speed * sinth * np.sin(phi),
         speed * costh]
    ).astype(np.float32)

    # centre-of-mass frame
    pos -= pos.mean(axis=1, keepdims=True)
    vel -= vel.mean(axis=1, keepdims=True)
    return pos.astype(np.float32), vel, m


def cold_sphere(n: int, seed: int = 0, total_mass: float = 1.0e10,
                radius: float = 1.0):
    """Uniform-density sphere at rest, the classic cold-collapse test.
    Default mass gives a free-fall time ~1.4 with the reference's G, so
    dt=0.01 resolves the collapse (~step 140)."""
    rng = np.random.default_rng(seed)
    r = radius * rng.random(n) ** (1.0 / 3.0)
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh**2)
    phi = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack(
        [r * sinth * np.cos(phi), r * sinth * np.sin(phi), r * costh]
    ).astype(np.float32)
    vel = np.zeros((3, n), np.float32)
    mass = np.full(n, total_mass / n, np.float32)
    return pos, vel, mass


DISTRIBUTIONS = {
    "reference": reference,
    "plummer": plummer,
    "cold_sphere": cold_sphere,
}


def make_arrays(name: str, n: int, seed: int = 42):
    try:
        gen = DISTRIBUTIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown distribution {name!r}; options: {sorted(DISTRIBUTIONS)}"
        ) from None
    return gen(n, seed=seed)
