"""Wall time of the traced admission round's finalize: its
``solver.finalize`` span (``core.ligd._finalize``: the per-user-split
GD, the host's β rounding, the SIC masks and the final Γ)."""
from portbench.lib import common


def read(ctx):
    tree = common.load_module("metrics", "admission_queue_wait_ms") \
        .traced_round(ctx, "admission.round")
    if tree is None:
        return None
    done = [s for s in tree[1] if s.name == "solver.finalize"]
    return 1e3 * sum(s.wall_s for s in done) if done else None
