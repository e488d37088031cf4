"""What every part of the benchmark shares: where things are, how a piece
is found by its name, and the checks a run makes of its own process.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a path runner ``paths/<name>.py`` and a per-layer
metric's reader ``metrics/<name>.py``: a later change adds a cell by adding
files, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"

# modules whose presence in the process after the window fails the run:
# the JAX stack and the JAX package, by whole top-level name (the port's
# own top-level name, ``repro_torch``, only begins with ``repro``)
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in {MANIFEST.name}")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, section: str, cell: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, or list no cells at all."""
    return [m for m in man[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that the run may not hold."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in modules}
    return sorted(t for t in tops if t in FORBIDDEN_TOP)
