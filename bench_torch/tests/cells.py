"""Cells of the benchmark cut to sizes a CPU test can run, with the real
cells' limits."""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import spec  # noqa: E402

# workload -> (n, mesh grid, dt): the cell's own blocks and segment, fewer
# bodies, a coarser mesh.  The upstream's masses grow with N, so the
# uniform cube's free-fall time goes as 1/N: its dt is scaled with it, so
# that the steps take the same share of it.
TINY = {
    "direct-n16384": (4096, None, None),
    "p3m-plummer-n262144": (2048, 16, None),
    "p3m-grad-plummer-n262144": (2048, 16, None),
    "p3m-uniform-n1048576": (4096, 16, 0.001 * 1048576 / 4096),
}


def tiny(workload: str) -> spec.Cell:
    n, grid, dt = TINY[workload]
    cell = spec.load(workload)
    cell.traffic = dict(cell.traffic, n=n, trace_segments=1,
                        dt=dt or cell.traffic["dt"])
    if grid:
        cell.config = dict(cell.config, grid=grid, program=dict(
            cell.config["program"], pm_grid=grid))
    return cell


def one_segment(monkeypatch) -> None:
    """The window runs exactly one segment, however slow the CPU: the same
    blocks through the same loop (``window.stretch`` with one segment),
    without the clock."""
    from harness import window

    monkeypatch.setattr(window, "timed",
                        lambda program, traffic, seconds, keep:
                        window.stretch(program, traffic, keep))
