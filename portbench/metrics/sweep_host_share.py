"""The share of the traced round's sweep in which the host was not
blocked on the done flag: 1 - the ``solver.layer`` spans' summed
``flag_wait_s`` over the ``solver.sweep`` span's wall time.  The host's
graph launches and the layers' eager work fill that share; the card waits
for the host in at most that part of the sweep."""
from portbench.lib import common


def read(ctx):
    found = common.load_module("metrics", "admission_sweep_ms").sweep(ctx)
    if found is None or not found[1]:
        return None
    sweep, layers = found
    waited = sum(s.fields.get("flag_wait_s", 0.0) for s in layers)
    return 100.0 * (1.0 - waited / sweep.wall_s)
