"""The measured window: the program's block loop, driven for a time.

The window replays one segment of ``segment_blocks`` sample blocks over and
over, each replay starting from the state set-up left (``Program.restore``),
so every run does the same work a step however fast it goes.  After each
block the program syncs once, reading the kinetic energy, and runs its P3M
plan health check.  Only whole blocks that end inside the window count.

What the window produced is kept for the check: every block's kinetic
energy with its place in the segment, and (the program's own tensors, no
copy) the state after the first block and after the last block the
reference follows, of the first segment and of the last whole one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@dataclasses.dataclass
class Outputs:
    kes: list = dataclasses.field(default_factory=list)  # (block in seg, ke)
    # block in segment -> (pos, vel): the first segment's, as it goes, and
    # the last whole segment's.
    first: dict = dataclasses.field(default_factory=dict)
    last: dict = dataclasses.field(default_factory=dict)
    _current: dict = dataclasses.field(default_factory=dict)
    _segments: int = 0

    def keep(self, k: int, state) -> None:
        self._current[k] = state
        if not self._segments:
            self.first[k] = state

    def segment_done(self) -> None:
        self.last = self._current
        self._current = {}
        self._segments += 1


@dataclasses.dataclass
class Run:
    blocks: int  # whole blocks inside the window
    steps: int
    seconds: float  # from the window's start to the end of its last block
    outputs: Outputs


def _block(program, b: int, seg_blocks: int, keep: tuple, out: Outputs,
           record=None):
    """Block ``b`` of the run (0-based): restore at a segment's start, run
    the block, the health check; returns the block's kinetic energy."""
    record = record or (lambda _: contextlib.nullcontext())
    k = b % seg_blocks
    if k == 0:
        with record("bench:restore"):
            program.restore()
    with record("bench:block"):
        ke = program.run_block()
    with record("bench:health"):
        program.health()
    out.kes.append((k, ke))
    if k in keep:
        out.keep(k, program.state())
    if k == seg_blocks - 1:
        out.segment_done()
    return ke


def timed(program, traffic: dict, seconds: float, keep: tuple) -> Run:
    """Blocks until ``seconds`` have passed; the block that ends past the
    window is not counted (its answer is still kept for the check)."""
    seg_blocks = int(traffic["segment_blocks"])
    out = Outputs()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    b, t_end = 0, t0
    while True:
        _block(program, b, seg_blocks, keep, out)
        t = time.perf_counter()
        if t > deadline:
            break
        b, t_end = b + 1, t
    return Run(b, b * program.block_steps, t_end - t0, out)


def stretch(program, traffic: dict, keep: tuple) -> Run:
    """The traced run's stretch: ``trace_segments`` whole segments, each
    block inside its ``bench:*`` ranges, the whole in ``bench:stretch``."""
    seg_blocks = int(traffic["segment_blocks"])
    blocks = seg_blocks * int(traffic["trace_segments"])
    out = Outputs()
    record = torch.profiler.record_function
    t0 = time.perf_counter()
    with record("bench:stretch"):
        for b in range(blocks):
            _block(program, b, seg_blocks, keep, out, record)
        program.sync()
    return Run(blocks, blocks * program.block_steps,
               time.perf_counter() - t0, out)
