"""Spans and named counters of the port: its only tracing mechanism.

* ``span(name)``: a context around one stage of the step.  While a
  ``torch.profiler`` session records, it is a
  ``torch.profiler.record_function("nbt." + name)`` range, on the
  profiler's own timeline: a host interval, and a device interval where the
  stage launched work.  So the spans share a clock with the device trace,
  and their nesting on the host thread says which span caused each kernel,
  copy and idle gap.  Without a session it is one shared no-op context, and
  the only cost is the check of the profiler's flag: ``record_function``
  alone costs microseconds a call even when nothing records.
* ``sync(site)``: ``span("sync." + site)`` around one host read of a
  device value (or a copy from pageable host memory, which waits for the
  stream), and one more on the counters ``host_syncs`` and
  ``"sync." + site``, whether or not a session records.  It adds no sync of
  its own.  On the CPU nothing waits, but the sites count the same.
* ``counts``: the named counters; ``reset()`` zeroes them.  Besides the
  syncs', ``ghost_images`` adds up the periodic ghost images that the
  health check counts (``pm.sr_plan_health``), from the value its
  ``sync.health`` read brings to the host: no sync of its own; and
  ``health_full_bins`` the checks that found more images than the ghost
  cap holds and binned again at the guaranteed 7N; ``fused_sweeps`` the
  force sweeps the fused blocks run (``ops/fused_block.py``), counted
  from the call's arguments.

No option turns the spans on: they record exactly when a profiler does,
under ``--profile-dir`` or a benchmark's traced run.  Spans opened in a
backward pass (``sr.vjp``) land on autograd's thread, not the caller's.

The span names, from the entry point down:

* host loop (``simulation.py``): ``block``, ``sync.ke``, ``health`` with
  its one read ``sync.health``, ``--debug-nans``' ``sync.finite``; at
  set-up ``setup.state``, ``setup.plan``, ``setup.warm``
  (``--profile-dir``'s trace opens before set-up);
* integrator (``models/integrators.py``): ``accel`` around each force
  evaluation, ``mesh.env`` around the block's mesh environment;
* fused sample block (``models/gravity.make_fused_block_fn``): ``fused``
  around the call of ``ops/fused_block.fused_block``, the block's one
  launch, not inside it (as ``pm._stage`` below);
* mesh solver (``ops/pm.py``): ``mesh.box``, ``mesh.deposit``,
  ``mesh.fft``, ``mesh.grids`` (the open boundary's spectrum products),
  ``mesh.ifft``, ``mesh.gather``, and on the periodic path
  ``mesh.ghosts``, each opened around the call of its function, not
  inside it (``pm._stage``): the profiler credits a kernel to the
  innermost range only, so a range a caller wraps around such a function
  keeps its kernels;
* P3M short range: ``p3m.bin``, ``sync.p3m_overflow``, ``p3m.worklist``,
  ``sr`` (the sweep) and ``sr.vjp`` (its backward);
* the copies of constants that wait for the stream: ``sync.box_quantiles``,
  ``sync.worklist_offsets``, ``sync.periodic_rc``, ``sync.ghost_table``,
  ``sync.ghost_combos``, ``sync.periodic_eps``, ``sync.periodic_h3``;
  the plan's reads ``sync.plan``.
"""

from __future__ import annotations

import collections
import contextlib

import torch

PREFIX = "nbt."

counts: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str):
    """The ``nbt.<name>`` range while a profiler records, else a no-op."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def sync(site: str):
    """``span("sync." + site)`` around one host sync, counted."""
    name = "sync." + site
    counts["host_syncs"] += 1
    counts[name] += 1
    return span(name)


def reset() -> None:
    counts.clear()
