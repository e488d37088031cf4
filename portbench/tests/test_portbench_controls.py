"""The controls, on the card at each cell's own size: the plain reference
in the precision below the configuration's (TF32 for the solver's
float32, fp8 e4m3 for the model's bfloat16), put in the program's place,
fails at least one of the cell's numbers on each of three seeds, while the
program's own run passes them all.  Each seed's readings are printed as
one JSON line (``-s`` shows them); ``portbench/lib/readings.py`` runs the
same readings for any number of seeds in one process."""
import json

import pytest
import torch

from portbench.lib import common, readings

SEEDS = (5101010101, 5202020202, 5303030303)
CELLS = [w["name"] for w in common.manifest()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the controls run at the cells' own size, on a card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_a_number(card, cell, seed):
    got = readings.reading(cell, seed, 10.0)
    print(json.dumps(got))
    assert got["correct"]
    control = got["control"]
    if not isinstance(control, dict):
        control = {"token_logit_gap": control}
    assert any(v > got["checks"][k]["limit"] for k, v in control.items())
