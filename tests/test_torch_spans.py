"""The port's spans and counters (``nbody_tpu_torch/utils/spans.py``) on the
CPU: free without a profiler, on the profiler's timeline with one, nested
as the step nests, one ``nbt.sync.*`` range for each count of
``host_syncs``, and no change to what a block computes."""

from __future__ import annotations

import ast
import glob
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_tpu_torch import SimConfig
from nbody_tpu_torch.simulation import _DeviceRunner
from nbody_tpu_torch.utils import spans

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "nbody_tpu_torch")

MESH_STAGES = ("nbt.mesh.box", "nbt.mesh.deposit", "nbt.mesh.fft",
               "nbt.mesh.grids", "nbt.mesh.ifft", "nbt.mesh.gather",
               "nbt.p3m.bin", "nbt.p3m.worklist", "nbt.sr")


@pytest.fixture
def one_thread():
    """One intra-op thread, so that repeated CPU blocks sum in one order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _runner(**kw) -> _DeviceRunner:
    runner = _DeviceRunner(SimConfig(platform="cpu", **kw))
    runner.prepare()
    return runner


def _p3m(**kw) -> _DeviceRunner:
    return _runner(n=512, nsteps=8, sfreq=4, kernel="p3m", pm_grid=16,
                   distribution="plummer", dt=0.01, **kw)


def _pm(**kw) -> _DeviceRunner:
    """Plain PM on a Plummer sphere: bodies outside the box take the far
    field."""
    return _runner(n=512, nsteps=8, sfreq=4, kernel="pm", pm_grid=16,
                   distribution="plummer", dt=0.01, **kw)


def _traced(fn):
    """Run ``fn`` under a CPU profiler: (the spans' events, sorted by start,
    as (start, end, name), the host_syncs delta)."""
    before = spans.counts["host_syncs"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("nbt."))
    return events, spans.counts["host_syncs"] - before


def _inside(inner, outers) -> bool:
    return any(s <= inner[0] and inner[1] <= e for s, e, _ in outers)


def test_span_without_a_profiler_is_the_flag_check(monkeypatch):
    """Without a session ``span`` returns one shared no-op context and never
    reaches ``record_function``, which costs microseconds a call even when
    nothing records."""
    assert not torch.autograd._profiler_enabled()

    def refused(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert spans.span("block") is spans.span("accel") is spans._OFF
    with spans.span("block"), spans.sync("ke"):
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("block"):
            pass
    assert [e.name for e in prof.events()] == ["nbt.block"]


def test_sync_counts_without_a_profiler():
    before = dict(spans.counts)
    with spans.sync("ke"):
        pass
    assert spans.counts["host_syncs"] == before.get("host_syncs", 0) + 1
    assert spans.counts["sync.ke"] == before.get("sync.ke", 0) + 1
    spans.reset()
    assert not spans.counts


def test_record_function_only_behind_the_guard():
    """The package calls ``record_function`` in the span module alone."""
    files = [f for f in glob.glob(os.path.join(PACKAGE, "**", "*.py"),
                                  recursive=True)
             if "record_function" in open(f).read()]
    assert files == [os.path.join(PACKAGE, "utils", "spans.py")]


def test_direct_block_spans():
    runner = _runner(n=256, nsteps=50, sfreq=50)
    events, syncs = _traced(lambda: runner.run_block(50))
    blocks = [e for e in events if e[2] == "nbt.block"]
    accels = [e for e in events if e[2] == "nbt.accel"]
    assert len(blocks) == 1 and len(accels) == 50
    assert all(_inside(a, blocks) for a in accels)
    assert [e[2] for e in events if e[2].startswith("nbt.sync.")] == [
        "nbt.sync.ke"]
    assert syncs == 1
    # No health check without a mesh tier.
    events, syncs = _traced(runner.check_sr_health)
    assert events == [] and syncs == 0


def test_p3m_block_spans():
    runner = _p3m()
    events, syncs = _traced(lambda: runner.run_block(4))
    names = [e[2] for e in events]
    accels = [e for e in events if e[2] == "nbt.accel"]
    assert len(accels) == 4 and names.count("nbt.mesh.env") == 1
    for stage in MESH_STAGES:
        got = [e for e in events if e[2] == stage]
        assert got and all(_inside(e, accels) for e in got), stage
    assert names.count("nbt.sync.p3m_overflow") == 4
    assert names.count("nbt.sync.ke") == 1
    assert sum(n.startswith("nbt.sync.") for n in names) == syncs
    # Overflow and worklist offsets a step; the env's box, the KE a block.
    assert syncs == 2 * 4 + 2

    events, syncs = _traced(runner.check_sr_health)
    health = [e for e in events if e[2] == "nbt.health"]
    reads = [e for e in events if e[2].startswith("nbt.sync.")]
    assert len(health) == 1 and all(_inside(e, health) for e in reads)
    # One box's quantiles, one worklist's offsets, one read of the triple.
    assert sorted(e[2] for e in reads) == [
        "nbt.sync.box_quantiles", "nbt.sync.health",
        "nbt.sync.worklist_offsets"]
    assert len(reads) == syncs == 3


def test_pm_block_spans():
    """Plain PM: every mesh stage inside each force call, the spectrum
    products' ``mesh.grids`` beside the inverse transforms' ``mesh.ifft``;
    a block syncs twice (the env's box quantiles, the KE) and has no
    health check."""
    runner = _pm()
    events, syncs = _traced(lambda: runner.run_block(4))
    accels = [e for e in events if e[2] == "nbt.accel"]
    assert len(accels) == 4
    # A force call opens mesh.box twice: the box and the moments, then
    # the far field.
    for stage, a_call in (("nbt.mesh.box", 2), ("nbt.mesh.deposit", 1),
                          ("nbt.mesh.fft", 1), ("nbt.mesh.grids", 1),
                          ("nbt.mesh.ifft", 1), ("nbt.mesh.gather", 1)):
        got = [e for e in events if e[2] == stage]
        assert len(got) == 4 * a_call, stage
        assert all(_inside(e, accels) for e in got), stage
    grids = [e for e in events if e[2] == "nbt.mesh.grids"]
    iffts = [e for e in events if e[2] == "nbt.mesh.ifft"]
    assert not any(_inside(e, grids) for e in iffts)
    assert sorted(e[2] for e in events if e[2].startswith("nbt.sync.")) == [
        "nbt.sync.box_quantiles", "nbt.sync.ke"]
    assert syncs == 2
    events, syncs = _traced(runner.check_sr_health)
    assert events == [] and syncs == 0


def _bare_grids_stage(monkeypatch):
    """``pm._stage`` with the ``mesh.grids`` span left out: that name calls
    its function bare."""
    from nbody_tpu_torch.ops import pm

    stage = pm._stage

    def bare(name, fn, *args, **kw):
        if name == "mesh.grids":
            return fn(*args, **kw)
        return stage(name, fn, *args, **kw)

    monkeypatch.setattr(pm, "_stage", bare)


@pytest.mark.parametrize("kind", ["pm", "p3m", "p3m_overflow"])
def test_grids_span_changes_no_force_or_sync(one_thread, monkeypatch, kind):
    """The ``mesh.grids`` span, recording under a profiler, leaves a force
    call's accelerations (and plain PM's gradient) bit for bit and its host
    syncs as they are without it; P3M with every body binned and with
    cells overflowing (the complement deposit inside the span)."""
    from nbody_tpu_torch.init import make_state
    from nbody_tpu_torch.ops import pm

    state = make_state(512, distribution="plummer", seed=3, device="cpu")
    pos, mass = state.pos, state.mass
    if kind == "pm":
        def call(p):
            return pm.accelerations(p, mass, 16)
    else:
        capacity = 2 if kind == "p3m_overflow" else 512
        assert (float(pm.cell_overflow_fraction(pos, mass, 16, 4, capacity))
                > 0) == (kind == "p3m_overflow")
        plan = pm.suggest_sr_plan(pos, mass, 16, 4, capacity=capacity)

        def call(p):
            return pm.p3m_accelerations(p, mass, 16, 4, **plan)

    def run():
        before = spans.counts["host_syncs"]
        p = pos.clone().requires_grad_(kind == "pm")
        acc = call(p)
        grad = torch.autograd.grad(acc.square().sum(), p)[0] \
            if kind == "pm" else None
        return acc.detach(), grad, spans.counts["host_syncs"] - before

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        acc, grad, syncs = run()
    assert [e.name for e in prof.events()].count("nbt.mesh.grids") == 1
    with monkeypatch.context() as m:
        _bare_grids_stage(m)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            acc0, grad0, syncs0 = run()
    assert "nbt.mesh.grids" not in [e.name for e in prof.events()]
    assert torch.equal(acc, acc0) and syncs == syncs0 > 0
    if grad is not None:
        assert torch.equal(grad, grad0)


def test_periodic_p3m_block_syncs_match_the_counter():
    runner = _runner(n=512, nsteps=8, sfreq=4, kernel="p3m", pm_grid=16,
                     pm_boundary="periodic", pm_box=1.0, dt=0.01)
    for fn in (lambda: runner.run_block(4), runner.check_sr_health):
        events, syncs = _traced(fn)
        names = [e[2] for e in events]
        assert sum(n.startswith("nbt.sync.") for n in names) == syncs > 0
    assert "nbt.sync.health" in names
    assert "nbt.mesh.ghosts" in names


def test_ghost_images_counts_the_health_checks_read():
    """``counts["ghost_images"]`` adds up the ghost images that the health
    check's ``sync.health`` read brings to the host, and opens no range of
    its own: the check's syncs are its one read and the constant copies of
    its one ghost build and one worklist."""
    import collections

    from nbody_tpu_torch.ops import pm

    runner = _runner(n=512, nsteps=8, sfreq=4, kernel="p3m", pm_grid=16,
                     pm_boundary="periodic", pm_box=1.0, dt=0.01)
    before = spans.counts["ghost_images"]
    full_bins = spans.counts["health_full_bins"]
    events, syncs = _traced(runner.check_sr_health)
    images = int(pm._plan_bin(runner.state.pos, runner.state.mass, 16, 4,
                              "periodic", 1.0)[3])
    assert spans.counts["ghost_images"] - before == images > 0
    # Every image fits the plan's ghost cap: no binning at 7N.
    assert images <= runner.cfg.pm_sr_ghosts
    assert spans.counts["health_full_bins"] == full_bins
    got = collections.Counter(e[2] for e in events
                              if e[2].startswith("nbt.sync."))
    assert got == {"nbt.sync.health": 1, "nbt.sync.periodic_rc": 1,
                   "nbt.sync.ghost_table": 1, "nbt.sync.ghost_combos": 1,
                   "nbt.sync.worklist_offsets": 1}
    assert sum(got.values()) == syncs
    # The solver's own ghost images, each step, are not counted.
    before = spans.counts["ghost_images"]
    runner.run_block(4)
    assert spans.counts["ghost_images"] == before


def _fused(**kw) -> _DeviceRunner:
    return _runner(n=256, nsteps=20, sfreq=10, fused=True, **kw)


def test_fused_block_spans(monkeypatch):
    """A fused block opens ``nbt.fused`` once, inside ``nbt.block``, around
    the call of ``fused_block`` and not inside it: a range wrapped around
    that function (as the benchmark's ``fused_roofline`` wraps it) lies
    inside the span; one sync (the KE).  On the CPU the block's plain
    version steps through the integrator, one ``nbt.accel`` a step inside
    the wrapped range, and no other program span opens there (on the card
    the block is one launch and opens none)."""
    from nbody_tpu_torch.ops import fused_block

    inner = fused_block.fused_block

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function("outer:fused"):
            return inner(*args, **kwargs)

    runner = _fused()
    monkeypatch.setattr(fused_block, "fused_block", wrapped)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run_block(10)
        runner.run_block(10)
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events())
    blocks = [e for e in events if e[2] == "nbt.block"]
    fused = [e for e in events if e[2] == "nbt.fused"]
    outer = [e for e in events if e[2] == "outer:fused"]
    assert len(blocks) == len(fused) == len(outer) == 2
    assert all(_inside(e, blocks) for e in fused)
    assert all(_inside(e, fused) for e in outer)
    spans_ = [e for e in events if e[2].startswith("nbt.")]
    assert [e[2] for e in spans_ if _inside(e, outer)] == ["nbt.accel"] * 20
    assert [e[2] for e in spans_ if not _inside(e, outer) and e[2] not in (
        "nbt.block", "nbt.fused")] == ["nbt.sync.ke"] * 2


@pytest.mark.parametrize("integrator,extra", [("euler", 0), ("leapfrog", 1)])
def test_fused_sweeps_counts_a_blocks_force_sweeps(integrator, extra):
    """``counts["fused_sweeps"]`` grows by the block's steps under Euler and
    one more under leapfrog (its re-seed), whether or not a profiler
    records, and adds no host sync."""
    runner = _fused(integrator=integrator)
    for traced in (False, True):
        before = dict(spans.counts)
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                runner.run_block(10)
        else:
            runner.run_block(10)
        assert (spans.counts["fused_sweeps"]
                - before.get("fused_sweeps", 0)) == 10 + extra
        assert spans.counts["host_syncs"] - before.get("host_syncs", 0) == 1


@pytest.mark.parametrize("kind", ["direct", "p3m"])
def test_block_is_bitwise_the_same_traced(one_thread, kind):
    make = (lambda: _runner(n=256, nsteps=50, sfreq=50)) if kind == "direct" \
        else _p3m
    steps = 50 if kind == "direct" else 4
    plain, traced = make(), make()
    ke = plain.run_block(steps)
    with profile(activities=[ProfilerActivity.CPU]):
        ke_traced = traced.run_block(steps)
    assert ke_traced == ke
    assert torch.equal(traced.state.pos, plain.state.pos)
    assert torch.equal(traced.state.vel, plain.state.vel)


def _wrapped_targets() -> dict:
    """label -> ``module:function`` or ``runner:attribute`` of every span the
    benchmark's metric files wrap (their ``SPANS``), read from the source:
    the benchmark's modules are not imported here."""
    out = {}
    for path in sorted(glob.glob(os.path.join(
            os.path.dirname(PACKAGE), "bench_torch", "metrics", "*.py"))):
        for node in ast.parse(open(path).read()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "SPANS" for t in node.targets):
                out.update(ast.literal_eval(node.value))
    return out


def test_spans_sit_around_the_wrapped_stage_functions():
    """The benchmark's per-layer metrics wrap some of the program's
    functions in profiler ranges of their own (``SPANS`` in
    ``bench_torch/metrics/``), and the profiler credits each kernel to the
    innermost range only: no program span other than a sync's may open
    inside one of those functions, or the wrapped range loses its
    kernels."""
    import importlib

    direct, p3m, plain, fused = (_runner(n=256, nsteps=50, sfreq=50),
                                 _p3m(), _pm(), _fused())
    periodic = _runner(n=512, nsteps=8, sfreq=4, kernel="p3m", pm_grid=16,
                       pm_boundary="periodic", pm_box=1.0, dt=0.01)
    saved = []

    def ranged(label, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function("outer:" + label):
                return fn(*args, **kwargs)
        return call

    try:
        for label, target in _wrapped_targets().items():
            where, attr = target.split(":")
            # A runner's force function is wrapped where it is one
            # kernel's call, the direct sum: a P3M force call holds the
            # mesh stages by design.
            owner = direct if where == "runner" else importlib.import_module(
                where)
            saved.append((owner, attr, getattr(owner, attr)))
            setattr(owner, attr, ranged(label, saved[-1][2]))
        for runner in (direct, p3m, plain, periodic, fused):
            runner._blocks.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            direct.run_block(50)
            p3m.run_block(4)
            plain.run_block(4)
            periodic.run_block(4)
            periodic.check_sr_health()
            fused.run_block(10)
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
    events = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events()]
    outer = [e for e in events if e[2].startswith("outer:")]
    assert bool(outer) == bool(saved)
    inner = [e for e in events if e[2].startswith("nbt.")
             and not e[2].startswith("nbt.sync.")]
    # On the CPU the fused block's plain version steps through the
    # integrator's force calls, each in ``nbt.accel``; on the card the block
    # is one launch and opens no span inside the wrapped entry.
    outer_fused = [e for e in outer if e[2] == "outer:fused"]
    assert not [e[2] for e in inner if _inside(e, outer) and not (
        e[2] == "nbt.accel" and _inside(e, outer_fused))]
    # Plain PM's spectrum products: the program's span opens around the
    # wrapped function, one a force call.
    wrapped = [e for e in outer if e[2] == "outer:mesh.grids"]
    spans_grids = [e for e in inner if e[2] == "nbt.mesh.grids"]
    assert len(wrapped) == 4
    assert all(_inside(e, spans_grids) for e in wrapped)
    # The fused block: the program's span opens around the wrapped entry.
    wrapped = [e for e in outer if e[2] == "outer:fused"]
    assert len(wrapped) == 1
    assert _inside(wrapped[0], [e for e in inner if e[2] == "nbt.fused"])


def test_profile_dir_holds_the_setup_spans(tmp_path):
    """``--profile-dir`` covers the run from set-up on: its trace holds
    ``nbt.setup.*`` beside the blocks' and the health check's spans."""
    from nbody_tpu_torch import run

    run(SimConfig(n=512, nsteps=8, sfreq=4, kernel="p3m", pm_grid=16,
                  distribution="plummer", dt=0.01, platform="cpu",
                  profile_dir=str(tmp_path)), quiet=True)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert {"nbt.setup.state", "nbt.setup.plan", "nbt.setup.warm",
            "nbt.block", "nbt.health", "nbt.sr"} <= names


def test_sr_vjp_span_in_the_backward():
    """The short-range sweep's backward opens ``nbt.sr.vjp``, on autograd's
    thread, after the forward's ``nbt.sr``."""
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.models.gravity import make_accel_fn

    pos, _, mass = (torch.tensor(a) for a in distributions.plummer(256,
                                                                   seed=18))
    fn = make_accel_fn("p3m", differentiable=True, grid=16, capacity=64)
    q = pos.clone().requires_grad_(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.mean(fn(q, mass) ** 2).backward()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name in ("nbt.sr", "nbt.sr.vjp"))
    assert [n for _, n in events] == ["nbt.sr", "nbt.sr.vjp"]
