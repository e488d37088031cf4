"""Model FLOPs the served Granite 4.0-H requests need
(``counts/granite.py``: each prompt's forward once, each further token's
decode step, the LM head at each served token) over the window's rounds'
time times the bf16 peak (989 TFLOP/s), over the rounds the traced
stretch did not touch."""
from portbench.lib import common
from portbench.lib.window import clear


def read(ctx):
    rec, st = ctx["rec"], ctx["st"]
    rounds = clear(rec["rounds"], rec["marks"], "t0", "t1")
    if not rounds:
        return None
    counts = common.load_module("counts", "granite")
    peaks = common.load_module("counts", "peaks")
    mix = st["mix"]
    per_round = ctx["path"].requests_per_round(st) * counts.request_flops(
        st["cfg"], mix["prompt_len"], mix["decode_steps"])
    wall = sum(r["t1"] - r["t0"] for r in rounds)
    return 100.0 * per_round * len(rounds) / (wall * peaks.BF16_FLOPS_S)
