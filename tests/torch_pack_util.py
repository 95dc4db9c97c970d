"""Numpy helpers for the port's packed slab tables: the sub-cell key, and a
pack with each cell's particles put in key order, written apart from the
port's own code to check it."""

from __future__ import annotations

import numpy as np


def subcell_key_np(pos, lo, span, nc: int, bits: int = 3):
    """The sub-cell Morton key of each particle, in numpy float32: its
    place inside its cell of the nc^3 grid over [lo, lo + span], cut into
    2^bits a axis and interleaved bit by bit, x the highest of each triple."""
    f32 = np.float32
    g = (np.asarray(pos, f32) - np.asarray(lo, f32)) * (
        f32(nc) / np.asarray(span, f32))
    frac = g - np.floor(np.clip(g, f32(0), f32(nc - 1)))
    q = np.clip(np.floor(frac * f32(1 << bits)), 0, (1 << bits) - 1)
    q = q.astype(np.int64)
    key = np.zeros(q.shape[1], np.int64)
    for b in range(bits):
        for axis in range(3):
            key |= ((q[axis] >> b) & 1) << (3 * b + 2 - axis)
    return key.astype(np.int32)


def reorder_pack_np(ptab, mtab, slab_lo, slab_hi, pslot, binned, cid, key):
    """A packed slab table set with the particles of each cell put in key
    order: every particle keeps its cell and the set of filled slots stays,
    so ``slab_lo``, ``slab_hi`` and ``binned`` come back unchanged.  With
    ``key`` the particle index, each cell is back in input order."""
    ptab, mtab, pslot = (np.array(a) for a in (ptab, mtab, pslot))
    body = np.flatnonzero(binned)
    by_slot = body[np.argsort(pslot[body])]
    assert np.array_equal(np.sort(pslot[body]), np.arange(body.size))
    new = by_slot[np.lexsort((key[by_slot], cid[by_slot]))]  # stable
    old = pslot[new]
    ptab[:, :new.size], mtab[:new.size] = ptab[:, old], mtab[old]
    pslot[new] = np.arange(new.size)
    return ptab, mtab, np.asarray(slab_lo), np.asarray(slab_hi), pslot, \
        np.asarray(binned)
