"""Mean wall time of the window's admission rounds, from the drain to the
install (``AdmissionRound.t_start`` to ``t_installed``, the controller's
clock), over the rounds the traced stretch did not touch."""
from portbench.lib.window import clear


def read(ctx):
    rec = ctx["rec"]
    rounds = clear(rec["rounds"], rec["marks"], "t_start", "t_installed")
    if not rounds:
        return None
    return 1e3 * sum(r["t_installed"] - r["t_start"]
                     for r in rounds) / len(rounds)
