"""The port's spans (``repro_torch.telemetry.spans``) and the benchmark's
readers of them (``portbench/metrics/``).

Off, a span records and keeps nothing.  On (``enable()``, or while a
torch profiler records), one admission round gives the span tree of the
admission loop, the sweep and the finalize, with the solver's counts in
the spans whose boundaries they count; one serving round gives the
serving tree.  Spans lie on the profiler's clock.  The ``cuda`` cases
place a kernel inside a span on the device trace's axis, time a span's
device work against CUDA events, and check the era_step launch counts of
a round on the card."""
import sys
import threading
import time
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import ligd, network, profiles
from repro_torch.kernels.era_step import kernel as era_kernel
from repro_torch.serving.cluster import SplitInferenceCluster
from repro_torch.telemetry import spans

pytestmark = pytest.mark.telemetry

ROOT = Path(__file__).resolve().parents[1]

ROUND_CHILDREN = ["admission.drain", "admission.restack", "solver.sweep",
                  "solver.finalize", "admission.build", "admission.swap"]
FINALIZE_CHILDREN = ["finalize.per_user_gd", "finalize.round_beta",
                     "finalize.discretize"]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def fresh_ring():
    assert not spans.recording()
    spans.clear()
    yield
    spans.clear()


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("the round's era_step launches run only on a card")
    return torch.device(name)


def _cluster(device, n_cells=2, n_users=6):
    ncfg = network.small_config(n_users=n_users, n_subchannels=3)
    scns = [network.make_scenario(torch.Generator().manual_seed(s), ncfg,
                                  device) for s in range(n_cells)]
    clock = FakeClock()
    prof = profiles.get_profile("nin", device)
    cluster = SplitInferenceCluster(
        None, None, prof, clock=clock, device=device,
        spec=ligd.SolverSpec(backend="chunked", max_steps=20,
                             per_user_split=True))
    ids = [cluster.add_cell(scn, 0.4) for scn in scns]
    cluster.start(threaded=False)
    return cluster, ids, clock, prof


def _named(got, name):
    return [s for s in got if s.name == name]


def _inside(child, parent):
    return parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns


# ------------------------------------------------------------------ off
def test_off_records_and_allocates_nothing():
    cluster, ids, clock, _ = _cluster("cpu")
    tracemalloc.start()
    try:
        for _ in range(100):
            with spans.span("x", n=1) as sp:
                sp.set(m=2)
                spans.add(k=1)
        clock.t = 1.0
        cluster.submit(ids[0], 1, 0.2)
        cluster.step()
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.Filter(True, spans.__file__)])
        assert sum(s.size for s in snap.statistics("filename")) == 0
    finally:
        tracemalloc.stop()
        cluster.stop(drain=False)
    assert spans.span("x") is spans.NO_SPAN and not spans.NO_SPAN
    assert spans.finished() == []


# ------------------------------------------------------- admission round
@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
def test_admission_round_span_tree(dev):
    device = _device(dev)
    cluster, ids, clock, prof = _cluster(device)
    try:
        clock.t = 1.0
        cluster.submit(ids[0], 1, 0.2)
        clock.t = 1.5
        cluster.submit(ids[1], 2, 0.3)
        clock.t = 1.75
        cluster.submit(ids[1], 4, 0.3)
        clock.t = 2.0
        stats0 = dict(ligd.SWEEP_STATS)
        launches0 = era_kernel.era_step_fused.launches
        with spans.enable():
            rnd = cluster.step()
        stats = {k: ligd.SWEEP_STATS[k] - v for k, v in stats0.items()}
        launches = era_kernel.era_step_fused.launches - launches0
    finally:
        cluster.stop(drain=False)
    got = spans.finished()
    (root,) = _named(got, "admission.round")
    assert root.parent_id is None and root.trace_id == 1
    assert {s.trace_id for s in got} == {1}
    f = root.fields
    assert f["n_arrivals"] == 3 and f["n_solved"] == 2
    assert f["partial"] is False
    # drain time 2.0 less the submit times 1.0, 1.5 and 1.75
    assert f["queue_wait_sum_s"] == pytest.approx(1.75)
    assert f["queue_wait_max_s"] == pytest.approx(1.0)
    assert rnd.t_start == 2.0

    children = sorted((s for s in got if s.parent_id == root.span_id),
                      key=lambda s: s.t0_ns)
    assert [s.name for s in children] == ROUND_CHILDREN
    assert children[1].fields["cells"] == 2
    for s in spans.subtree(root, got):
        parent = next(p for p in got if p.span_id == s.parent_id)
        assert _inside(s, parent), (s, parent)
    for a, b in zip(children, children[1:]):
        assert a.t1_ns <= b.t0_ns

    (sweep,) = _named(got, "solver.sweep")
    layers = _named(got, "solver.layer")
    assert len(layers) == prof.n_layers + 1
    assert [s.fields["split"] for s in layers] == list(range(len(layers)))
    assert all(s.parent_id == sweep.span_id for s in layers)
    (fin,) = _named(got, "solver.finalize")
    assert [s.name for s in got if s.parent_id == fin.span_id] \
        == FINALIZE_CHILDREN
    (gd,) = _named(got, "finalize.per_user_gd")

    counted = layers + [gd]
    for key in ("replays", "flag_reads"):
        assert sum(s.fields.get(key, 0) for s in counted) == stats[key], key
    assert sweep.fields["launches"] + gd.fields["launches"] == launches
    for s in counted:
        assert 0 < s.fields["steps"] <= 20
        assert 0 <= s.fields["flag_wait_s"] <= s.wall_s
        assert 0 <= s.fields["replay_s"] <= s.wall_s
        assert s.fields["flag_reads"] <= s.fields["replays"]
    if device.type == "cuda":
        assert launches > 0
        assert all(s.device_s is not None and s.device_s >= 0 for s in got)


# ---------------------------------------------------------- serve round
def test_serve_round_span_tree():
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import transformer

    cfg = get_tiny_config("mamba2-780m")
    model = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu")
    prof = profiles.transformer_profile(cfg, seq=16, device="cpu")
    ncfg = network.small_config(n_users=6, n_subchannels=3)
    cluster = SplitInferenceCluster(model, cfg, prof, device="cpu",
                                    spec=ligd.SolverSpec(max_steps=5))
    ids = [cluster.add_cell(network.make_scenario(
        torch.Generator().manual_seed(i), ncfg, "cpu")) for i in range(2)]
    cluster.start(threaded=False)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6, 16)).astype(np.int32)
    try:
        with spans.enable():
            cluster.serve_round(toks, decode_steps=4)
    finally:
        cluster.stop(drain=False)
    got = spans.finished()
    (root,) = _named(got, "serve.round")
    assert root.fields == {"n_cells": 2, "n_users": 12}
    cells = [s for s in got if s.parent_id == root.span_id]
    assert [s.name for s in cells] == ["serve.cell"] * 2
    for cell, cid in zip(cells, ids):
        inner = [s for s in got if s.parent_id == cell.span_id]
        groups = _named(inner, "serve.split_group")
        assert len(groups) == cell.fields["groups"] \
            == len(cluster.installed_schedule(cid).groups())
        assert sum(g.fields["rows"] for g in groups) == 6
        assert [s.name for s in inner] == (["serve.split_group"]
                                           * len(groups)
                                           + ["serve.prefill",
                                              "serve.decode"])
        # two Mamba-2 layers' decode state for 6 users: float32 states
        # (16 heads of 32 x state 32) and bf16 conv histories (3 x 576)
        assert inner[-1].fields == {"steps": 3, "graphed": False,
                                    "captures": 0, "replays": 0,
                                    "attn_launches": 0,
                                    "ssm_state_bytes": 2 * 6 * (
                                        16 * 32 * 32 * 4 + 3 * 576 * 2),
                                    "kv_bytes": 0}
        for s in inner:
            assert _inside(s, cell) and _inside(cell, root)


@pytest.mark.parametrize("dev", ["cpu", pytest.param("cuda",
                                                     marks=pytest.mark.cuda)])
def test_serve_decode_span_counts_the_decode_graph(dev):
    """``serve.decode``'s ``graphed``, ``captures`` and ``replays`` over
    two rounds of two cells of one shape: on the CPU every decode runs
    eagerly; on a card the first captures the graph (its first step runs
    eagerly) and every other step of both rounds replays it, as
    ``engine.DECODE_GRAPH`` counts."""
    from repro_torch.configs import get_tiny_config
    from repro_torch.models import transformer
    from repro_torch.serving import engine

    if dev == "cuda" and not torch.cuda.is_available():
        pytest.skip("a CUDA graph is captured and replayed only on a card")
    device = torch.device(dev)
    cfg = get_tiny_config("mamba2-780m")
    model = transformer.init(torch.Generator().manual_seed(0), cfg, device)
    prof = profiles.transformer_profile(cfg, seq=16, device=device)
    ncfg = network.small_config(n_users=6, n_subchannels=3)
    cluster = SplitInferenceCluster(model, cfg, prof, device=device,
                                    spec=ligd.SolverSpec(max_steps=5))
    for i in range(2):
        cluster.add_cell(network.make_scenario(
            torch.Generator().manual_seed(i), ncfg, device))
    cluster.start(threaded=False)
    rng = np.random.default_rng(0)
    before = (engine.DECODE_GRAPH.captures, engine.DECODE_GRAPH.replays)
    try:
        with spans.enable():
            for _ in range(2):
                cluster.serve_round(rng.integers(
                    0, cfg.vocab_size, (2, 6, 16)), decode_steps=4)
    finally:
        cluster.stop(drain=False)
    counts = (engine.DECODE_GRAPH.captures - before[0],
              engine.DECODE_GRAPH.replays - before[1])
    got = [(s.fields["graphed"], s.fields["captures"], s.fields["replays"])
           for s in _named(spans.finished(), "serve.decode")]
    if dev == "cpu":
        assert got == [(False, 0, 0)] * 4 and counts == (0, 0)
    else:
        assert got == [(True, 1, 2)] + [(True, 0, 3)] * 3
        assert counts == (1, 11)


# ------------------------------------------------------------- switches
def test_profiler_records_spans_on_its_clock():
    def other_thread():
        out = []
        t = threading.Thread(target=lambda: out.append(
            spans.profiler_recording()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        return out[0]

    assert not spans.profiler_recording() and not other_thread()
    with spans.span("before") as sp:
        assert not sp
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.profiler_recording() and other_thread()
        with spans.span("warm-up"):
            pass
        for k in range(3):
            with spans.span(f"work{k}", k=k):
                torch.randn(64, 64) @ torch.randn(64, 64)
    assert not spans.profiler_recording()
    with spans.span("after"):
        pass
    got = spans.finished()
    assert [s.name for s in got] == ["warm-up", "work0", "work1", "work2"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for s in got[1:]:
        e = events[s.name]
        assert abs(e.start_ns() - s.t0_ns) <= 50_000, (s, e.start_ns())
        assert abs(e.end_ns() - s.t1_ns) <= 50_000, (s, e.end_ns())


def test_span_open_when_the_tracer_turns_off_is_kept():
    on = spans.enable()
    on.__enter__()
    outer = spans.span("outer")
    outer.__enter__()
    on.__exit__(None, None, None)
    assert not spans.recording()
    with spans.span("inner") as inner:
        assert not inner
        spans.add(n=2)                    # lands on the open outer span
    outer.__exit__(None, None, None)

    with profile(activities=[ProfilerActivity.CPU]):
        late = spans.span("late")
        late.__enter__()
    late.__exit__(None, None, None)
    got = spans.finished()
    assert [s.name for s in got] == ["outer", "late"]
    assert got[0].fields == {"n": 2}
    assert got[1].t1_ns >= got[1].t0_ns


def test_ring_is_bounded_and_exports_to_a_bus():
    from repro_torch.telemetry import TelemetryBus

    tracer = spans.Tracer(capacity=3)
    bus = TelemetryBus()
    with tracer.enable(bus):
        for k in range(5):
            with tracer.span("s", trace_id=70 + k, k=k):
                pass
    with tracer.span("off"):
        pass
    got = tracer.finished()
    assert [s.fields["k"] for s in got] == [2, 3, 4]
    assert [s.trace_id for s in got] == [72, 73, 74]
    lines = bus.snapshot("span")
    assert [e.fields["k"] for e in lines] == list(range(5))
    assert lines[0].fields["span"] == "s"
    assert {"span_id", "parent_id", "trace_id", "t0_ns", "t1_ns"} \
        <= set(lines[0].fields)
    tracer.clear()
    assert tracer.finished() == []


# ---------------------------------------------------------------- a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("device time is read from a card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_on_the_device_trace(cuda_device):
    x = torch.randn(4096, 4096, device=cuda_device)

    def work():
        for _ in range(20):
            x @ x

    work()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.span("work") as sp:
            work()
        torch.cuda.synchronize()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    kernels = [e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert kernels
    assert start_ns + 1e3 * min(kernels) >= sp.t0_ns

    def timed():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        work()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / 1e3

    ref = [timed()]
    with spans.enable():
        with spans.span("timed") as sp:
            work()
    ref.append(timed())
    (got,) = [s for s in spans.finished() if s is sp]
    assert got.device_s == pytest.approx(np.mean(ref), rel=0.05)


# ---------------------------------------------- the benchmark's readers
def _reader(name):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.lib import common
    return common.load_module("metrics", name).read


def _admission_round():
    """A recorded round's spans in the program's shape."""
    with spans.enable():
        with spans.span("admission.round", trace_id=9,
                        n_arrivals=4) as rnd:
            rnd.set(queue_wait_sum_s=2.0, queue_wait_max_s=0.9)
            with spans.span("admission.drain"):
                pass
            with spans.span("solver.sweep") as sweep:
                for s in range(3):
                    with spans.span("solver.layer", split=s):
                        time.sleep(0.002)
                        spans.add(flag_wait_s=0.0005)
                sweep.set(launches=40)
            with spans.span("solver.finalize"):
                time.sleep(0.001)
    got = spans.finished()
    return {s.name: s for s in got}


def _serve_round():
    with spans.enable():
        with spans.span("serve.round"):
            for _ in range(2):
                with spans.span("serve.cell"):
                    for name in ("serve.split_group", "serve.split_group",
                                 "serve.prefill", "serve.decode"):
                        with spans.span(name):
                            pass
    got = spans.finished()
    times = dict(zip(("serve.split_group", "serve.prefill",
                      "serve.decode"), (0.25, 0.125, 0.0625)))
    for s in got:
        s.device_s = times.get(s.name)
    return times


ERA_READERS = ["admission_queue_wait_ms", "admission_sweep_ms",
               "admission_finalize_ms", "sweep_step_ms", "sweep_host_share"]
SERVE_READERS = {"edge_forward_ms": 4 * 250.0, "prefill_ms": 2 * 125.0,
                 "decode_ms": 2 * 62.5}


@pytest.mark.parametrize("name", ERA_READERS)
def test_admission_span_readers(name):
    read = _reader(name)
    assert read(dict(trace={})) is None             # nothing recorded
    by = _admission_round()
    sweep, fin = by["solver.sweep"], by["solver.finalize"]
    want = {
        "admission_queue_wait_ms": 1e3 * 2.0 / 4,
        "admission_sweep_ms": 1e3 * sweep.wall_s,
        "admission_finalize_ms": 1e3 * fin.wall_s,
        "sweep_step_ms": 1e3 * sweep.wall_s / 40,
        "sweep_host_share": 100.0 * (1 - 3 * 0.0005 / sweep.wall_s),
    }[name]
    assert read(dict(trace={})) == pytest.approx(want)
    assert read(dict(trace=None)) is None           # an untraced run


@pytest.mark.parametrize("name", sorted(SERVE_READERS))
def test_serve_span_readers(name):
    read = _reader(name)
    assert read(dict(trace={})) is None
    _serve_round()
    assert read(dict(trace={})) == pytest.approx(SERVE_READERS[name])
    assert read(dict(trace=None)) is None
    # spans without device time (the CPU's) give nothing
    for s in spans.finished():
        s.device_s = None
    assert read(dict(trace={})) is None
