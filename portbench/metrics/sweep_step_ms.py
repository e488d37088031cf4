"""Wall time of the traced round's sweep over the era_step launches in it
(the ``solver.sweep`` span's ``launches``: one launch is one GD step of
every lane), so a step's share of the sweep alone, without the round's
restack, finalize, schedule building and swap."""
from portbench.lib import common


def read(ctx):
    found = common.load_module("metrics", "admission_sweep_ms").sweep(ctx)
    if found is None or not found[0].fields.get("launches"):
        return None
    return 1e3 * found[0].wall_s / found[0].fields["launches"]
