"""The least time the rounds' GD steps need over the rounds' wall time, as
a share: each step's bytes (era_step's operands and outputs and the new
allocation, ``counts/era_step.py``, at the round's lanes) read or written
once at the HBM's 3.35 TB/s, whatever kernels implement the step."""
from portbench.lib import common
from portbench.lib.window import clear


def read(ctx):
    rec, st = ctx["rec"], ctx["st"]
    counts = common.load_module("counts", "era_step")
    peaks = common.load_module("counts", "peaks")
    steps = common.load_module("metrics", "gd_step_ms").with_launches(rec)
    rounds = clear(steps, rec["marks"], "t_start", "t_installed")
    net = st["cfg"]["network"]
    need = sum(r["steps"] * counts.gd_step_bytes(
        len(r["cells"]), net["n_subchannels"], net["n_users"], net["n_aps"])
        for r in rounds) / peaks.HBM_BYTES_S
    wall = sum(r["t_installed"] - r["t_start"] for r in rounds)
    return 100.0 * need / wall if wall > 0 and need > 0 else None
