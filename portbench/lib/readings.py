"""Readings that set a cell's limits: for each seed, one run of the cell
on the card with its numbers compared, and the control's readings of the
same numbers (the plain reference in the precision below the
configuration's, put in the program's place).  One process for all seeds;
one JSON line a seed.

    python3 portbench/lib/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 10
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from portbench import run as bench  # noqa: E402
from portbench.reference import precision  # noqa: E402

# the step below each configuration's precision (the controls)
CONTROL = {"float32": precision.tf32, "bfloat16": precision.fp8}


def control_after(seed):
    """What a run adds after its check: the control's readings, and where
    the runner has them, its readings of the check's start (``starts``)."""
    def after(path, st, rec):
        cfg = st["cfg"]
        dtype = cfg.get("dtype") or cfg["model"]["dtype"]
        out = dict(control=path.control(st, rec, seed, CONTROL[dtype]))
        if hasattr(path, "starts"):
            out["starts"] = path.starts(st, rec, seed)
        return out
    return after


def reading(cell, seed, seconds):
    """One seed's run on the card with its controls, as a JSON-ready dict."""
    out = bench.run_cell(cell, seed, seconds, False, "cuda", t_started=0.0,
                         after=control_after(seed))
    return dict(cell=cell, seed=seed, correct=out["correct"],
                checks=out["checks"], metrics=out["metrics"], **out["after"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(reading(args.workload, int(s), args.seconds)),
              flush=True)


if __name__ == "__main__":
    main()
