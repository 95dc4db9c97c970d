"""Stdout reporting, byte-compatible with the reference's table.

The reference prints with sticky ``std::setprecision(5)`` and left-aligned
``setw`` columns (ver0/GSimulation.cpp:176-234; refactored as
print_header/print_stats/print_flops in ver5_all/GSimulation.cpp:117-168).
The kenergy column of this table is the cross-implementation comparison
artifact, so the format is reproduced exactly — including the reference's
"Perfomance" spelling and the C++ iostream rendering of NaN as "-nan"
(which the reference emits when fewer than three sample blocks ran).
A copy of ``nbody_tpu.utils.reporting``, so the port runs without JAX."""

from __future__ import annotations

import math
import re


def _g5(v: float) -> str:
    """C++ ostream default-float rendering at precision 5 (printf %.5g)."""
    if isinstance(v, float) and math.isnan(v):
        return "-nan"
    return f"{v:.5g}"


def banner() -> str:
    return "===============================\n Initialize Gravity Simulation"


def print_banner(out=None) -> None:
    emit(banner(), out)


def header(n: int, nsteps: int, dt: float) -> str:
    lines = [
        f" nPart = {n}; nSteps = {nsteps}; dt = {dt:g}",
        "-" * 48,
        " " + "s".ljust(8) + "dt".ljust(8) + "kenergy".ljust(12)
        + "time (s)".ljust(12) + "GFlops".ljust(12),
        "-" * 48,
    ]
    return "\n".join(lines)


def stats_row(s: int, t_phys: float, kenergy: float, seconds: float,
              gflops: float) -> str:
    return (
        " "
        + str(s).ljust(8)
        + _g5(t_phys).ljust(8)
        + _g5(kenergy).ljust(12)
        + _g5(seconds).ljust(12)
        + _g5(gflops).ljust(12)
    )


def footer(nthreads: int, total_time: float, av: float, dev: float) -> str:
    return (
        "\n"
        f"# Number Threads     : {nthreads}\n"
        f"# Total Time (s)     : {_g5(total_time)}\n"
        f"# Average Perfomance : {_g5(av)} +- {_g5(dev)}\n"
        + "=" * 31
    )


_ROW_RE = re.compile(r"^ (\d+)\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+)\s*$")


def parse_trace(text: str) -> list:
    """Inverse of ``stats_row`` for captured tables (ours or the C++
    reference's): returns [(step, kenergy_string)].  The kenergy strings
    are %.5g renderings — string comparison asserts agreement at full
    printed precision (the golden-trace fidelity gate)."""
    rows = []
    for line in text.splitlines():
        m = _ROW_RE.match(line)
        if m:
            rows.append((int(m.group(1)), m.group(3)))
    return rows


def emit(text: str, out=None) -> None:
    if out is None:
        print(text, flush=True)
    else:
        out.write(text + "\n")



# Named like the reference's refactored printers (ver5_all/GSimulation.cpp:
# 117-168): print_header / print_stats / print_flops.

def print_header(n, nsteps, dt, out=None):
    emit(header(n, nsteps, dt), out)


def print_stats(s, t_phys, kenergy, seconds, gflops, out=None):
    emit(stats_row(s, t_phys, kenergy, seconds, gflops), out)


def print_flops(nthreads, total_time, av, dev, out=None):
    emit(footer(nthreads, total_time, av, dev), out)
