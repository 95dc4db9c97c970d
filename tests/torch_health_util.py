"""The states on which ``pm.sr_plan_health`` is held to the three public
plan functions it stands for, shared by the CPU tests and the card's
(the card runs the paired worklist layout, the CPU the symmetric one).
Imports neither JAX nor the JAX package."""

from __future__ import annotations

import numpy as np
import torch

from chip_smoke import corner_blob
from nbody_tpu_torch.models import distributions
from nbody_tpu_torch.ops import pm
from nbody_tpu_torch.utils import spans

PERIODIC = dict(boundary="periodic", box_size=1.0)

# name: (state, grid, plan overrides, boundary keywords, whether the
# images overflow the ghost cap); "plan" takes the measured plan's value.
CASES = {
    "open-uniform": ("cube", 32, {}, {}, False),
    "open-plummer-capacity-8": ("plummer", 64, {"capacity": 8}, {}, False),
    "periodic-healthy": ("box", 32, {}, PERIODIC, False),
    "periodic-ghosts-8": ("blob", 32, {"sr_ghosts": 8}, PERIODIC, True),
    "periodic-default-ghost-cap": ("box", 32, {"sr_ghosts": 0}, PERIODIC,
                                   False),
    "periodic-entries-64": ("blob", 32, {"sr_entries": 64}, PERIODIC, False),
    "open-entries-64": ("plummer", 64, {"sr_entries": 64}, {}, False),
    "periodic-entries-0": ("box", 32, {"sr_entries": 0}, PERIODIC, False),
    "open-entries-0": ("cube", 32, {"sr_entries": 0}, {}, False),
}


def _state(kind: str):
    if kind == "plummer":
        pos, _, mass = distributions.plummer(4096, seed=9)
        return pos, mass
    if kind == "blob":
        return corner_blob(1024, 11)
    rng = np.random.default_rng(6)
    pos = np.asarray(rng.random((3, 4096)), np.float32)
    if kind == "cube":
        pos = 2.0 * pos - 1.0
    return pos, np.asarray(1.0 + rng.random(4096), np.float32)


def check_health_equals_the_plan_functions(name: str, device) -> tuple:
    """``sr_plan_health`` on CASES[name] equals ``cell_overflow_fraction``,
    ``ghost_overflow_count`` and ``sr_entry_overflow`` called apart, bit for
    bit, and counts the images it read and its full binnings.  Returns the
    triple."""
    kind, grid, over, bkw, full_bin = CASES[name]
    pos, mass = _state(kind)
    p = torch.tensor(pos, device=device)
    m = torch.tensor(mass, device=device)
    plan = pm.suggest_sr_plan(p, m, grid, 4, **bkw)
    plan = dict(plan, **over)
    plan.setdefault("sr_ghosts", 0)
    images = int(pm._plan_bin(p, m, grid, 4, **bkw)[3]) if bkw else 0
    before = dict(spans.counts)
    got = pm.sr_plan_health(p, m, grid, 4, **plan, **bkw)
    delta = {k: spans.counts[k] - before.get(k, 0)
             for k in ("ghost_images", "health_full_bins")}
    frac = float(pm.cell_overflow_fraction(p, m, grid, 4, plan["capacity"],
                                           **bkw))
    ghosts = pm.ghost_overflow_count(p, m, grid, 4, plan["sr_ghosts"],
                                     box_size=1.0) if bkw else 0
    entries = pm.sr_entry_overflow(p, m, grid, 4, **plan, **bkw)
    assert got == (frac, ghosts, entries)
    assert [type(v) for v in got] == [float, int, int]
    assert delta == {"ghost_images": images, "health_full_bins": int(full_bin)}
    gcap = pm._ghost_cap(p.shape[1], plan["sr_ghosts"])
    assert (images > gcap) == full_bin
    return got
