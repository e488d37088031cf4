"""Wall time of the traced admission round's Li-GD sweep: its
``solver.sweep`` span (``core.ligd._sweep_core``, the F+1 split layers)."""
from portbench.lib import common


def sweep(ctx):
    """(the traced round's ``solver.sweep`` span, its ``solver.layer``
    spans), or None."""
    tree = common.load_module("metrics", "admission_queue_wait_ms") \
        .traced_round(ctx, "admission.round")
    if tree is None:
        return None
    inner = tree[1]
    sweeps = [s for s in inner if s.name == "solver.sweep"]
    if len(sweeps) != 1:
        return None
    layers = [s for s in inner if s.name == "solver.layer"
              and s.parent_id == sweeps[0].span_id]
    return sweeps[0], layers


def read(ctx):
    found = sweep(ctx)
    return None if found is None else 1e3 * found[0].wall_s
