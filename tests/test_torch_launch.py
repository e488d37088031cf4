"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU, in each of its modes: one cell, ``--cells N`` and the async
cluster with ``--governor --trace --churn``; and its device rule: without
``--device`` it serves on the card, so with no card it raises."""
import collections
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--tiny", "--users", "6", "--subchannels", "4", "--seq-len", "16",
         "--decode-steps", "2"]


def _launch(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # one intra-op thread: the suite's other workers share the cores
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_one_cell_mode():
    out = _launch("--arch", "dbrx-132b", *SMALL)
    lines = out.splitlines()
    assert lines[0].startswith("served 6 users | mean latency")
    assert "QoE violations" in lines[0]
    users = [ln for ln in lines if ln.startswith("  user ")]
    assert len(users) == 4 and all("-> tokens [" in ln for ln in users)


def test_multi_cell_mode():
    out = _launch("--arch", "mixtral-8x22b", "--cells", "2", *SMALL)
    for b in range(2):
        assert f"[cell {b}] served 6 users | mean latency" in out
        assert sum(ln.startswith(f"[cell {b}]   user ")
                   for ln in out.splitlines()) == 4


def test_async_mode_with_governor_trace_and_churn(tmp_path):
    trace = tmp_path / "trace.jsonl"
    out = _launch("--arch", "mixtral-8x22b", "--cells", "2",
                  "--async-admission", "--rounds", "6", "--governor",
                  "--churn", "--trace", str(trace), *SMALL)
    lines = out.splitlines()
    assert sum(ln.startswith("[round ") for ln in lines) == 6
    assert any(ln.startswith("churn: round 2: +cell 2") for ln in lines)
    assert any(ln.startswith("churn: round 4: -cell 0") for ln in lines)
    assert any(ln.startswith("async admission: ") and "6/6 serving rounds"
               in ln for ln in lines)
    table = lines[lines.index("telemetry summary:") + 1:]
    rows = {ln[2:28].strip(): ln[28:].strip() for ln in table
            if ln.startswith("  ")}
    for label in ("admission rounds", "solve wall p50/p99 ms",
                  "swap-to-serve p99 ms", "QoE attainment (mean)",
                  "serve rounds", "round errors", "governor deferred",
                  "governor prioritised", "governor forced"):
        assert label in rows, label
    assert rows["round errors"] == "0"
    assert lines[-1] == f"telemetry trace -> {trace}"
    events = [json.loads(ln) for ln in trace.read_text().splitlines()]
    streams = collections.Counter(e["event"] for e in events)
    for name in ("bootstrap", "admission_round", "serve_round", "cell_join",
                 "cell_leave", "schedule_swap", "qoe_attainment"):
        assert streams[name] > 0, name
    # the spans of every round, on the profiler's clock
    got = [e for e in events if e["event"] == "span"]
    names = collections.Counter(e["span"] for e in got)
    assert names["serve.round"] == 7
    assert names["admission.round"] == streams["admission_round"]
    for name in ("serve.cell", "serve.split_group", "serve.prefill",
                 "serve.decode", "admission.drain", "solver.sweep",
                 "solver.layer", "solver.finalize", "admission.swap"):
        assert names[name] > 0, name
    assert all(e["t1_ns"] >= e["t0_ns"] for e in got)
    # the warm-up round plus the six timed rounds
    assert streams["serve_round"] == 7
    assert int(rows["serve rounds"]) == 7
    assert int(rows["admission rounds"]) == streams["admission_round"]


def test_without_device_the_launcher_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma-2b", *SMALL])


@pytest.mark.parametrize("flags", [["--backend", "sharded"],
                                   ["--backend", "multihost"],
                                   ["--sharded-solver"]])
def test_unported_backends_raise_naming_the_roadmap(flags, capsys):
    """The sharded backends and the legacy alias are ported: they no
    longer raise.  With ``--device cpu`` the cells mesh is one shard on
    the host, and the one-cell mode drops to the single-device backend."""
    assert serve.main(["--arch", "gemma-2b", *SMALL, *flags,
                       "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    backend = "multihost" if "multihost" in flags else "sharded"
    if backend == "multihost":
        assert lines.pop(0).startswith("multihost solver: process 0/1, ")
    assert lines[0] == f"{backend} solver: 1-shard cells mesh on cpu"
    assert lines[1].startswith("served 6 users | mean latency")


def test_sharded_multi_cell_mode():
    out = _launch("--arch", "mixtral-8x22b", "--cells", "3", "--backend",
                  "sharded", *SMALL)
    assert out.splitlines()[0] == "sharded solver: 1-shard cells mesh on cpu"
    for b in range(3):
        assert f"[cell {b}] served 6 users | mean latency" in out
