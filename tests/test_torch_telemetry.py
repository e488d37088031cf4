"""The port's telemetry bus + sinks + instrumented serving seams
(``repro_torch.telemetry``, the port's cluster on the CPU): the mirror of
tests/test_telemetry.py.

Unit layer: ring-buffer bounding, streaming aggregates (P² quantile
sketch vs exact numpy quantiles), injectable clock, drain/snapshot
semantics, JSONL FileSink round-trip, thread-safety of concurrent
emitters.  Integration layer: the admission/engine/cluster event streams
documented in README "Observability" actually appear — round phases,
solve wall time, swap-to-serve lag, per-cell QoE attainment, bounded
``round_error`` backlog — all under a fake clock, no numpy sort on the
emit path."""
import io
import json
import threading
import tracemalloc

import numpy as np
import pytest

import torch

import repro_torch.telemetry.bus as bus_mod
from repro_torch.telemetry import Event, FileSink, TelemetryBus, spans

pytestmark = pytest.mark.telemetry


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ------------------------------------------------------------------ bus
def test_emit_snapshot_and_injected_clock():
    clock = FakeClock()
    bus = TelemetryBus(clock=clock)
    bus.emit("round", n=1)
    clock.advance(2.5)
    bus.emit("round", n=2, note="second")
    evs = bus.snapshot("round")
    assert [e.t for e in evs] == [0.0, 2.5]
    assert evs[0] == Event(0.0, "round", {"n": 1})
    assert evs[1].fields == {"n": 2, "note": "second"}
    assert bus.count("round") == 2
    assert bus.streams() == ["round"]
    assert bus.snapshot("never") == [] and bus.count("never") == 0


def test_ring_bounded_but_aggregates_cover_history():
    bus = TelemetryBus(capacity=8)
    for i in range(100):
        bus.emit("s", v=float(i))
    evs = bus.snapshot("s")
    assert len(evs) == 8                      # ring kept the tail...
    assert [e.fields["v"] for e in evs] == [float(i) for i in range(92, 100)]
    s = bus.summary("s", "v")
    assert s.count == 100                     # ...aggregates kept it all
    assert s.min == 0.0 and s.max == 99.0
    assert s.mean == pytest.approx(49.5)


def test_drain_clears_window_not_aggregates():
    bus = TelemetryBus()
    for i in range(10):
        bus.emit("s", v=float(i))
    assert len(bus.drain("s")) == 10
    assert bus.snapshot("s") == []
    assert bus.count("s") == 10
    assert bus.summary("s", "v").count == 10
    assert bus.drain("s") == []


def test_non_numeric_and_bool_fields_not_aggregated():
    bus = TelemetryBus()
    bus.emit("s", kind="swap", ok=True, n=3)
    assert bus.summary("s", "kind") is None
    assert bus.summary("s", "ok") is None     # bool is not a metric
    assert bus.summary("s", "n").count == 1
    # but all fields ride on the event itself
    assert bus.snapshot("s")[0].fields == {"kind": "swap", "ok": True,
                                           "n": 3}


def test_summary_of_missing_stream_or_field_is_none():
    bus = TelemetryBus()
    bus.emit("s", v=1.0)
    assert bus.summary("s", "w") is None
    assert bus.summary("t", "v") is None


def test_p2_quantiles_match_numpy():
    rng = np.random.default_rng(0)
    bus = TelemetryBus(capacity=16)           # far smaller than the stream
    xs = rng.lognormal(mean=0.0, sigma=1.0, size=20_000)
    for x in xs:
        bus.emit("lat", v=float(x))
    s = bus.summary("lat", "v")
    for got, p in ((s.p50, 50), (s.p95, 95), (s.p99, 99)):
        exact = float(np.percentile(xs, p))
        assert got == pytest.approx(exact, rel=0.05), (p, got, exact)


def test_small_sample_quantiles_exact():
    bus = TelemetryBus()
    for x in (3.0, 1.0, 2.0):
        bus.emit("s", v=x)
    s = bus.summary("s", "v")
    assert s.p50 == 2.0
    bus2 = TelemetryBus()
    assert bus2.summary("s", "v") is None


def test_concurrent_emitters_lose_nothing():
    bus = TelemetryBus(capacity=100_000)
    n, threads = 2_000, 8

    def work(k):
        for i in range(n):
            bus.emit("s", v=float(i), src=k)

    ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert bus.count("s") == n * threads
    assert bus.summary("s", "v").count == n * threads


def test_capacity_validation():
    with pytest.raises(ValueError):
        TelemetryBus(capacity=0)


# ---------------------------------------------------------------- sinks
def test_file_sink_jsonl_roundtrip(tmp_path):
    path = tmp_path / "trace.jsonl"
    clock = FakeClock()
    bus = TelemetryBus(clock=clock)
    sink = FileSink(path)
    bus.attach(sink)
    bus.emit("round", n=1, arr=np.float32(2.5))
    clock.advance(1.0)
    bus.emit("swap", version=3, kind="install")
    bus.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines == [
        {"t": 0.0, "event": "round", "n": 1, "arr": 2.5},
        {"t": 1.0, "event": "swap", "version": 3, "kind": "install"},
    ]


def test_detached_sink_sees_nothing_more():
    buf = io.StringIO()
    bus = TelemetryBus()
    sink = FileSink(buf, flush_every=1)
    bus.attach(sink)
    bus.emit("a")
    bus.detach(sink)
    bus.emit("b")
    assert [json.loads(ln)["event"]
            for ln in buf.getvalue().splitlines()] == ["a"]


# ----------------------------------------- instrumented serving seams
def _scn(seed, ncfg):
    from repro_torch.core import network
    return network.make_scenario(torch.Generator().manual_seed(seed), ncfg,
                                 "cpu")


def _cluster(bus, governor=None, n_cells=2, n_users=6):
    from repro_torch.core import network, profiles
    from repro_torch.core.ligd import SolverSpec
    from repro_torch.serving.cluster import SplitInferenceCluster

    ncfg = network.small_config(n_users=n_users, n_subchannels=3)
    scns = [_scn(s, ncfg) for s in range(n_cells)]
    clock = FakeClock()
    if bus is not None:
        bus.clock = clock
    cluster = SplitInferenceCluster(
        None, None, profiles.get_profile("nin", "cpu"),
        spec=SolverSpec(max_steps=5, per_user_split=False),
        clock=clock, bus=bus, governor=governor, device="cpu")
    ids = [cluster.add_cell(scn, 0.4) for scn in scns]
    cluster.start(threaded=False)
    return cluster, ids, clock


def test_serving_stack_emits_documented_streams():
    bus = TelemetryBus()
    cluster, ids, clock = _cluster(bus)
    assert bus.count("bootstrap") == 1
    boot = bus.snapshot("bootstrap")[0].fields
    assert boot["version"] == 1 and boot["n_cells"] == 2
    assert boot["solve_wall_s"] > 0 and boot["iters"] > 0
    # bootstrap measured attainment for every cell
    assert bus.count("qoe_attainment") == 2

    clock.advance(1.0)
    cluster.submit(ids[0], 1, 0.2)
    rnd = cluster.step()
    assert rnd is not None
    ev = bus.snapshot("admission_round")[-1].fields
    assert ev["version"] == 2 and ev["n_arrivals"] == 1
    assert ev["n_solved"] == 1 and ev["solve_wall_s"] > 0
    assert ev["round_wall_s"] >= ev["solve_wall_s"]
    # the touched cell's attainment was re-measured
    att = [e.fields for e in bus.snapshot("qoe_attainment")]
    assert att[-1]["cell"] == 0 and att[-1]["version"] == 2
    assert 0.0 <= att[-1]["attainment"] <= 1.0

    # swap-to-serve lag: first snapshot of a fresh version, on the
    # fake clock
    clock.advance(0.25)
    cluster.engine.round_snapshot()
    lags = bus.snapshot("swap_to_serve")
    assert lags[-1].fields["version"] == 2
    assert lags[-1].fields["lag_s"] == pytest.approx(0.25)
    n_lags = len(lags)
    cluster.engine.round_snapshot()           # same version: no new lag
    assert len(bus.snapshot("swap_to_serve")) == n_lags
    assert bus.count("schedule_swap") == 2    # install + swap
    cluster.stop(drain=False)


def test_churn_emits_join_and_leave():
    from repro_torch.core import network

    bus = TelemetryBus()
    cluster, ids, clock = _cluster(bus)
    ncfg = network.small_config(n_users=6, n_subchannels=3)
    new_id = cluster.add_cell(_scn(9, ncfg), 0.4)
    join = bus.snapshot("cell_join")[-1].fields
    assert join["lane"] == 2 and join["solve_wall_s"] > 0
    cluster.remove_cell(ids[0])
    leave = bus.snapshot("cell_leave")[-1].fields
    assert leave["lane"] == 0 and leave["n_cells"] == 2
    assert cluster.qoe_attainment(new_id) >= 0.0
    cluster.stop(drain=False)


def test_round_error_event_and_bounded_backlog():
    from repro_torch.serving.admission import ERROR_BACKLOG

    bus = TelemetryBus()
    cluster, ids, clock = _cluster(bus)
    ctl = cluster.controller
    assert ctl.errors.maxlen == ERROR_BACKLOG

    boom = RuntimeError("solver exploded")

    def exploding(*a, **kw):
        raise boom

    ctl.scheduler.schedule = exploding
    ctl.start()
    done = ctl.round_done
    for i in range(ERROR_BACKLOG + 5):
        done.clear()
        cluster.submit(ids[0], 0, 0.2)
        assert done.wait(30.0)
    cluster.stop(drain=False)
    # backlog stayed bounded; every failure still landed on the bus
    assert len(ctl.errors) == ERROR_BACKLOG
    assert all(e is boom for e in ctl.errors)
    assert bus.count("round_error") >= ERROR_BACKLOG + 5
    ev = bus.snapshot("round_error")[-1].fields
    assert ev["kind"] == "RuntimeError" and "solver exploded" in ev["error"]


def test_no_bus_path_touches_no_telemetry():
    # the bus=None serving path, spans off, must stay allocation-free
    # w.r.t. the telemetry package: no Event, no ring, no sketch updates,
    # no span
    cluster, ids, clock = _cluster(None)
    assert not spans.recording()
    tracemalloc.start()
    try:
        clock.advance(1.0)
        cluster.submit(ids[0], 1, 0.2)
        cluster.step()
        cluster.engine.round_snapshot()
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, bus_mod.__file__),
             tracemalloc.Filter(True, spans.__file__)])
        assert sum(s.size for s in snap.statistics("filename")) == 0
    finally:
        tracemalloc.stop()
        cluster.stop(drain=False)
