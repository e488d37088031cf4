"""Nothing of the benchmark imports the JAX stack or the JAX package, by
whole top-level name (the port's own name, ``repro_torch``, begins with
``repro``); the reference imports nothing of the port."""
import ast
from pathlib import Path

import pytest

from portbench.lib import common

FILES = sorted(p for p in common.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def tops(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(common.BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not tops(path) & {"jax", "jaxlib", "flax", "repro"}
    if path.parent.name == "reference":
        assert "repro_torch" not in tops(path)
    assert "benchmarks" not in tops(path)


def test_whole_name_comparison():
    assert common.forbidden_modules({"repro_torch": 1,
                                     "repro_torch.core": 1}) == []
    assert common.forbidden_modules({"repro.core": 1, "jax": 1}) == \
        ["jax", "repro"]
