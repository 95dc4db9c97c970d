"""BENCHMARK.json and the files it names: every cell loads, every metric has
a reader, and the names keep to the benchmark's rules."""

from __future__ import annotations

import json
import os
import re
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import run  # noqa: E402  (bench_torch/run.py)
from harness import reference, spec  # noqa: E402

with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_loads(workload):
    cell = spec.load(workload)
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m.moves in e2e for m in cell.per_layer)
    assert callable(reference.solver(cell.config["solver"]).forces)
    if cell.job == "rollout_grad":
        assert callable(reference.solver(cell.config["solver"]
                                         + "_grad").force)
    assert "program" in cell.config["control"] or cell.config["control"] == {
        "reference": "bf16"}
    assert cell.traffic["n"] > 0 and cell.traffic["block_steps"] > 0
    assert 1 <= cell.check["reference_blocks"] <= cell.traffic[
        "segment_blocks"]
    assert set(cell.check["limits"]) <= set(run.checker(cell).NUMBERS)
    # Each limit lies between the readings it was set from, with more room
    # above the program's than below the control's.
    for v in cell.check["limits"].values():
        assert 0 < v["lower"] < v["limit"] < v["upper"]
        assert v["limit"] / v["lower"] > v["upper"] / v["limit"]


# The accepted cells of the block loop, as their PRs left them: their
# files and the metrics they report.
ACCEPTED = {
    "direct-n16384": ("direct-f32", "ref-n16384", {"setup_s", "step_ms",
                      "gflops"}, {"device_idle", "direct_roofline",
                                  "host_syncs_per_step", "sync_idle_ms"}),
    "p3m-plummer-n262144": ("p3m-open", "plummer-n262144", {"setup_s",
                            "step_ms"}, {"device_idle", "sr_roofline",
                                         "mesh_ms", "host_syncs_per_step",
                                         "sync_idle_ms", "health_ms"}),
    "p3m-uniform-n1048576": ("p3m-open", "ref-n1048576", {"setup_s",
                             "step_ms"}, {"device_idle", "sr_roofline",
                                          "mesh_ms", "host_syncs_per_step",
                                          "sync_idle_ms", "health_ms"}),
}


@pytest.mark.parametrize("workload", sorted(ACCEPTED))
def test_accepted_cells_keep_their_files_and_metrics(workload):
    config, traffic, e2e, layer = ACCEPTED[workload]
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert (w["config"], w["traffic"], w["chips"]) == (config, traffic, 1)
    cell = spec.load(workload)
    assert cell.job == "block_loop" and "job" not in cell.traffic
    assert cell.config["name"] == config
    assert {m.name for m in cell.end_to_end} == e2e
    assert {m.name for m in cell.per_layer} == layer
    assert run.checker(cell).NUMBERS == ("ke", "dv", "x")


def test_job_is_checked():
    cell = spec.load("p3m-grad-plummer-n262144")
    assert cell.job == "rollout_grad"
    assert {m.name for m in cell.per_layer} == {
        "device_idle", "host_syncs_per_step", "sync_idle_ms",
        "sr_vjp_roofline", "backward_ms"}
    for changes in ({"wrt": ["pos"]}, {"job": "no_such_job"}):
        with pytest.raises(ValueError):
            spec.job(dict(cell.traffic, **changes))
    assert spec.job({}) == "block_loop"


def test_names_files_and_readers():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in metrics]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for m in metrics:
        assert callable(spec.reader(m["name"]))
    # Every span a metric reads names the program's function as
    # "module:function" or "runner:attribute".
    spans = spec.spans([spec.Metric(m["name"], m["unit"], None)
                        for m in BENCH["per_layer"]])
    assert spans and all(len(t.split(":")) == 2 for t in spans.values())
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_unknown_workload():
    with pytest.raises(KeyError):
        spec.load("no-such-cell")
