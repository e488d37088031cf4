"""Wall time of the admission rounds over the era_step launches in them
(``era_step_fused.launches``, counted by graph replays too; one launch is
one GD step of every lane in the round), over the rounds the traced
stretch did not touch."""
from portbench.lib.window import clear


def with_launches(rec):
    """The window's rounds, each with its own era_step launches."""
    prev = rec["prev"]["launches"]
    out = []
    for r in rec["rounds"]:
        out.append(dict(r, steps=r["launches"] - prev))
        prev = r["launches"]
    return out


def read(ctx):
    rec = ctx["rec"]
    rounds = clear(with_launches(rec), rec["marks"], "t_start",
                   "t_installed")
    steps = sum(r["steps"] for r in rounds)
    if not steps:
        return None
    return 1e3 * sum(r["t_installed"] - r["t_start"]
                     for r in rounds) / steps
