"""Bit-compatible reimplementation of the reference's initial-condition RNG.

The reference seeds ``std::mt19937 gen(42)`` independently for every particle
field and draws through ``std::uniform_real_distribution<float>``
(reference: ver0/GSimulation.cpp:44-93).  To reproduce its initial conditions
bit-for-bit we reimplement, in vectorized numpy:

* the MT19937 engine (standard Matsumoto-Nishimura constants, 32-bit), and
* libstdc++'s ``generate_canonical<float, 24>`` reduction, which for a 32-bit
  engine performs exactly ONE engine call per draw and computes
  ``float(u32) / float(2**32)`` in fp32, clamping results ``>= 1.0f`` to
  ``nextafter(1.0f, 0.0f)`` (GCC 12 bits/random.tcc, generate_canonical), and
* ``uniform_real_distribution::operator()`` = ``canonical * (b - a) + a``
  evaluated in fp32 (GCC 12 bits/random.h:1869-1874).

Validated bit-exactly against fixtures produced by a GCC 12 build
(tests/golden/mt19937_42_*.{u32,f32}, generated by tools/rng_fixture_gen.cpp).
A copy of ``nbody_tpu.utils.mt19937``, so the port runs without JAX.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint64(0x9908B0DF)
_UPPER = np.uint64(0x80000000)
_LOWER = np.uint64(0x7FFFFFFF)
_MASK32 = np.uint64(0xFFFFFFFF)


class MT19937:
    """Vectorized 32-bit Mersenne Twister, state-compatible with std::mt19937."""

    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = np.uint64(seed) & _MASK32
        # std::mt19937 seeding: mt[i] = 1812433253*(mt[i-1] ^ (mt[i-1]>>30)) + i
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
                (x & np.uint64(1)).astype(bool), _MATRIX_A, np.uint64(0)
            )

        # Waves chosen so every read is already final:
        #   new[i] = src[i + M (mod N)] ^ tw((old-or-new[i] & UPPER) | (next[i] & LOWER))
        # i in [0, N-M): sources entirely old.
        i1 = slice(0, _N - _M)
        x = (old[0 : _N - _M] & _UPPER) | (old[1 : _N - _M + 1] & _LOWER)
        new[i1] = old[_M:_N] ^ tw(x)
        # i in [N-M, 2*(N-M)): new[i-(N-M)] comes from wave 1.
        a, b = _N - _M, 2 * (_N - _M)
        x = (old[a:b] & _UPPER) | (old[a + 1 : b + 1] & _LOWER)
        new[a:b] = new[0 : b - a] ^ tw(x)
        # i in [2*(N-M), N-1): new[i-(N-M)] comes from wave 2.
        c = _N - 1
        x = (old[b:c] & _UPPER) | (old[b + 1 : c + 1] & _LOWER)
        new[b:c] = new[b - a : c - a] ^ tw(x)
        # i = N-1 wraps: uses new[0].
        x = (old[_N - 1] & _UPPER) | (new[0] & _LOWER)
        new[_N - 1] = new[_N - 1 - a] ^ tw(x)

        self._mt = new
        self._idx = 0

    def raw(self, count: int) -> np.ndarray:
        """Next ``count`` tempered 32-bit outputs as uint32."""
        out = np.empty(count, dtype=np.uint64)
        filled = 0
        while filled < count:
            if self._idx >= _N:
                self._twist()
            take = min(count - filled, _N - self._idx)
            out[filled : filled + take] = self._mt[self._idx : self._idx + take]
            self._idx += take
            filled += take
        # Tempering.
        y = out
        y ^= y >> np.uint64(11)
        y ^= (y << np.uint64(7)) & np.uint64(0x9D2C5680)
        y ^= (y << np.uint64(15)) & np.uint64(0xEFC60000)
        y ^= y >> np.uint64(18)
        return (y & _MASK32).astype(np.uint32)


def generate_canonical_f32(raw_u32: np.ndarray) -> np.ndarray:
    """libstdc++ generate_canonical<float, 24> over a 32-bit engine.

    One engine call per draw; fp32 arithmetic throughout; clamp >=1 to
    nextafter(1, 0) (GCC 12 behaviour — clamps rather than redraws).
    """
    x = raw_u32.astype(np.float32)  # rounds to 24-bit mantissa, may hit 2^32
    ret = x / np.float32(4294967296.0)
    clamp = np.nextafter(np.float32(1.0), np.float32(0.0))
    return np.where(ret >= np.float32(1.0), clamp, ret).astype(np.float32)


def uniform_real_f32(seed: int, count: int, a: float, b: float) -> np.ndarray:
    """std::uniform_real_distribution<float>(a, b) over std::mt19937(seed)."""
    gen = MT19937(seed)
    canon = generate_canonical_f32(gen.raw(count))
    return (canon * (np.float32(b) - np.float32(a)) + np.float32(a)).astype(
        np.float32
    )
