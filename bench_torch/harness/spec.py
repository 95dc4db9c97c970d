"""A cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
check or one metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the configuration (the solver, the program's
  options, the physics), as ``BENCHMARK.json``'s ``file`` names it;
* ``traffic/<traffic>.json``: the initial conditions (distribution, N),
  the time step, the sample block and the segment the window replays, and
  the segments the traced run profiles; and the ``job`` the window drives
  (``JOBS``): the program's block loop by default, or ``rollout_grad``,
  one gradient of a ``block_steps``-step rollout a block;
* ``checks/<workload>.json``: the blocks of the segment the reference
  follows, and each compared number's limit with the two readings it was
  set from (``lower``: the program's largest, ``upper``: the control's
  smallest);
* ``metrics/<metric>.py``: a reader, ``read(ctx) -> float | None``, and
  for a per-layer metric the spans it reads, ``SPANS``: label -> the
  program's function that the traced run wraps in ``bench:<label>``;
* ``references/<solver>.py``: the plain reference's force for the
  configuration's ``solver`` (``reference.py``), and
  ``references/<solver>_grad.py`` its force for a rollout gradient
  (``grad_check.py``).

So a later cell or metric is added as files and entries, and no file here
changes.
"""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

TRAFFIC_KEYS = ("distribution", "n", "dt", "block_steps", "segment_blocks",
                "trace_segments")
# The jobs a window can drive; a rollout gradient also names what it is
# taken with respect to, which is the initial positions and velocities.
JOBS = ("block_loop", "rollout_grad")
GRAD_WRT = ["pos", "vel"]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    moves: str | None  # per-layer metrics: the end-to-end metric


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list

    @property
    def job(self) -> str:
        return job(self.traffic)


def job(traffic: dict) -> str:
    """The job a traffic mix drives, refused unless the window can drive
    it."""
    name = traffic.get("job", "block_loop")
    if name not in JOBS or (name == "rollout_grad"
                            and traffic.get("wrt") != GRAD_WRT):
        raise ValueError(f"job {name!r} (wrt {traffic.get('wrt')!r}); "
                         f"options: {JOBS}, a rollout gradient with respect "
                         f"to {GRAD_WRT}")
    return name


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries, workload: str, reported=None) -> list:
    """The metrics this cell reports: those whose ``workloads`` name it, or
    that have none; a per-layer metric only where what it moves is
    reported."""
    return [Metric(e["name"], e["unit"], e.get("moves")) for e in entries
            if workload in e.get("workloads", (workload,))
            and (reported is None or e["moves"] in reported)]


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload`` in ``<root>/BENCHMARK.json``."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"options: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    missing = [k for k in TRAFFIC_KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic {w['traffic']!r} lacks {missing}")
    job(traffic)
    check = _read_json(os.path.join(HERE, "checks", workload + ".json"))
    e2e = _metrics(bench["end_to_end"], workload)
    layer = _metrics(bench["per_layer"], workload,
                     reported={m.name for m in e2e})
    return Cell(workload, int(w["chips"]), config, traffic, check, e2e, layer)


_MODULES = {}


def _module(metric: str):
    """``metrics/<metric>.py``, loaded once."""
    import importlib.util

    if metric not in _MODULES:
        path = os.path.join(HERE, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[metric] = mod
    return _MODULES[metric]


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(metric).read


def spans(metrics) -> dict:
    """label -> target of every span the given metrics read."""
    out = {}
    for m in metrics:
        for label, target in getattr(_module(m.name), "SPANS", {}).items():
            if out.setdefault(label, target) != target:
                raise ValueError(f"span {label!r} wraps both {out[label]!r} "
                                 f"and {target!r}")
    return out
