"""The shard mesh of a particle-sharded run.

The JAX package shards over a 1-D ``jax.sharding.Mesh`` that one process
drives (``shard_map``).  The port keeps that single controller: a ``Mesh``
is a tuple of K ``torch.device``s, one per shard.  On one card every slot
is that card ("virtual shards", as ``--xla_force_host_platform_device_count``
gives the JAX tests virtual CPU devices); the collectives of
``decompose.py`` move tensors with ``.to(device)``, so shards on several
cards of one host need no change to their callers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..state import device_or_card

AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple  # one torch.device per shard

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_shards: int,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """A mesh of ``n_shards`` slots: by default all on the current card
    (raising without one); the CPU only when asked, as
    ``devices=[torch.device("cpu")] * K``.  More shards than given devices
    raises."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        return Mesh((device_or_card(),) * n_shards)
    devs = [torch.device(d) for d in devices]
    if n_shards > len(devs):
        raise ValueError(
            f"requested {n_shards} devices, only {len(devs)} available")
    return Mesh(tuple(devs[:n_shards]))
