"""BENCHMARK.json against the benchmark's contract: names, units and keys,
and every cell's configuration, mix, runner and metric readers found by
name."""
import json
import re

import pytest

from portbench.lib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = common.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(common.MANIFEST.read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_plain_and_unique(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in MAN["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        e2e = {x["name"] for x in MAN["end_to_end"]}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = common.config(w["config"])
    assert cfg["name"] == w["config"]
    assert (common.BENCH / "paths" / f"{cfg['path']}.py").exists()
    kind = common.traffic(w["traffic"])["kind"]
    assert (common.BENCH / "generators" / f"{kind}.py").exists()
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"portbench/configs/{w['config']}.json"
    assert set(entry["reduced"]) <= _keys(cfg)
    assert set(cfg["limits"]) and all(v >= 0 for v in cfg["limits"].values())
    e2e = [m["name"] for m in common.metrics_for(MAN, "end_to_end",
                                                 w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert common.metrics_for(MAN, "per_layer", w["name"])


def _keys(d):
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            out |= _keys(v)
    return out


def test_every_config_has_a_cell():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    json.dumps(MAN)
