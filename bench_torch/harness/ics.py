"""Initial conditions from the seed, for the plain reference.

The reference rebuilds the initial state itself rather than taking the
program's: these are copies of the upstream's generators, so the check also
holds the program's initial conditions to the upstream's.

* ``reference``: the upstream's initial conditions (ver0/GSimulation.cpp:
  44-93): every field drawn from a freshly seeded ``std::mt19937`` through
  ``std::uniform_real_distribution<float>``; positions U(0, 1), velocities
  U(-1, 1) * 1e-3, masses N * U(0, 1) reusing the position draws.  Seed 42
  is the upstream's own run; any other seed keeps the draw structure.
* ``plummer``: a Plummer (1911) sphere in virial equilibrium (total mass
  1e10, scale radius 1), velocities by von Neumann rejection (Aarseth,
  Henon & Wielen 1974), in the centre-of-mass frame, from numpy's
  ``default_rng(seed)``.

Both return host fp32 arrays: pos (3, N), vel (3, N), mass (N,).
"""

from __future__ import annotations

import numpy as np

G_NEWTON = 6.67259e-11

_N = 624
_M = 397
_MATRIX_A = np.uint64(0x9908B0DF)
_UPPER = np.uint64(0x80000000)
_LOWER = np.uint64(0x7FFFFFFF)
_MASK32 = np.uint64(0xFFFFFFFF)


class MT19937:
    """32-bit Mersenne Twister, state-compatible with std::mt19937."""

    def __init__(self, seed: int):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = np.uint64(seed & 0xFFFFFFFF)
        f = np.uint64(1812433253)
        for i in range(1, _N):
            prev = mt[i - 1]
            mt[i] = (f * (prev ^ (prev >> np.uint64(30))) + np.uint64(i)) & _MASK32
        self._mt = mt
        self._idx = _N

    def _twist(self) -> None:
        old = self._mt
        new = np.empty(_N, dtype=np.uint64)

        def tw(x):
            return (x >> np.uint64(1)) ^ np.where(
                (x & np.uint64(1)).astype(bool), _MATRIX_A, np.uint64(0))

        # In three waves, so that every element read is already final.
        a, b, c = _N - _M, 2 * (_N - _M), _N - 1
        x = (old[0:a] & _UPPER) | (old[1:a + 1] & _LOWER)
        new[0:a] = old[_M:_N] ^ tw(x)
        x = (old[a:b] & _UPPER) | (old[a + 1:b + 1] & _LOWER)
        new[a:b] = new[0:b - a] ^ tw(x)
        x = (old[b:c] & _UPPER) | (old[b + 1:c + 1] & _LOWER)
        new[b:c] = new[b - a:c - a] ^ tw(x)
        x = (old[_N - 1] & _UPPER) | (new[0] & _LOWER)
        new[_N - 1] = new[_N - 1 - a] ^ tw(x)
        self._mt = new
        self._idx = 0

    def raw(self, count: int) -> np.ndarray:
        """The next ``count`` tempered outputs as uint32."""
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        while filled < count:
            if self._idx >= _N:
                self._twist()
            take = min(count - filled, _N - self._idx)
            out[filled:filled + take] = self._mt[self._idx:self._idx + take]
            self._idx += take
            filled += take
        y = out
        y ^= y >> np.uint64(11)
        y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680)
        y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000)
        y ^= y >> np.uint64(18)
        return (y & _MASK32).astype(np.uint32)


def canonical_f32(raw: np.ndarray) -> np.ndarray:
    """libstdc++'s generate_canonical<float, 24> over a 32-bit engine: one
    engine call a draw, fp32 throughout, a result of 1 clamped below it."""
    ret = raw.astype(np.float32) / np.float32(4294967296.0)
    below_one = np.nextafter(np.float32(1.0), np.float32(0.0))
    return np.where(ret >= np.float32(1.0), below_one, ret).astype(np.float32)


def _uniform_f32(seed: int, count: int, a: float, b: float) -> np.ndarray:
    canon = canonical_f32(MT19937(seed).raw(count))
    return (canon * (np.float32(b) - np.float32(a)) + np.float32(a)).astype(
        np.float32)


def reference(n: int, seed: int):
    if seed == 42:
        # The upstream's own arithmetic: canonical * (b - a) + a, in fp32.
        u01 = canonical_f32(MT19937(42).raw(3 * n))
        u11 = (u01 * np.float32(2.0) + np.float32(-1.0)).astype(np.float32)
    else:
        u01 = _uniform_f32(seed, 3 * n, 0.0, 1.0)
        u11 = _uniform_f32(seed, 3 * n, -1.0, 1.0)
    pos = u01.reshape(n, 3).T.copy()
    vel = (u11 * np.float32(1e-3)).astype(np.float32).reshape(n, 3).T.copy()
    mass = (np.float32(n) * u01[:n]).astype(np.float32)
    return pos, vel, mass


def plummer(n: int, seed: int, total_mass: float = 1.0e10,
            scale_radius: float = 1.0):
    rng = np.random.default_rng(seed)
    m = np.full(n, total_mass / n, np.float32)
    u = rng.random(n)
    r = scale_radius / np.sqrt(np.maximum(u, 1e-12) ** (-2.0 / 3.0) - 1.0)
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([r * sinth * np.cos(phi), r * sinth * np.sin(phi),
                    r * costh]).astype(np.float32)
    # q = v / v_esc has the density q^2 (1 - q^2)^(7/2).
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
        r * r + scale_radius * scale_radius) ** -0.25
    speed = q * v_esc
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rng.uniform(0, 2 * np.pi, n)
    vel = np.stack([speed * sinth * np.cos(phi), speed * sinth * np.sin(phi),
                    speed * costh]).astype(np.float32)
    pos -= pos.mean(axis=1, keepdims=True)
    vel -= vel.mean(axis=1, keepdims=True)
    return pos.astype(np.float32), vel, m


DISTRIBUTIONS = {"reference": reference, "plummer": plummer}


def make(distribution: str, n: int, seed: int):
    if distribution not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {distribution!r}; options: "
                         f"{sorted(DISTRIBUTIONS)}")
    return DISTRIBUTIONS[distribution](n, seed)
