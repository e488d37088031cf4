"""era_step's byte bound (``counts/era_step.py``: operands and outputs
once, at 3.35 TB/s) over the device time of its five launches, per call,
from the traced stretch; the call's lanes from the rounds that ran in the
stretch (weighted by their steps)."""
from portbench.lib import common
from portbench.lib.trace import calls
from portbench.lib.window import touched

ERA_LAUNCHES = ("pass0_kernel", "colsum_kernel", "tail_kernel",
                "pass1_kernel", "colsum_kernel")


def read(ctx):
    tr, rec, st = ctx["trace"], ctx["rec"], ctx["st"]
    if tr is None:
        return None
    times = calls(tr["kernels"], ERA_LAUNCHES)
    steps = common.load_module("metrics", "gd_step_ms").with_launches(rec)
    live = [r for r in touched(steps, rec["marks"], "t_start", "t_installed")
            if r["steps"]]
    if not times or not live:
        return None
    lanes = sum(len(r["cells"]) * r["steps"] for r in live) / sum(
        r["steps"] for r in live)
    counts = common.load_module("counts", "era_step")
    peaks = common.load_module("counts", "peaks")
    net = st["cfg"]["network"]
    per_lane = counts.era_step_bytes(1, net["n_subchannels"],
                                     net["n_users"], net["n_aps"])
    bound = lanes * per_lane / peaks.HBM_BYTES_S
    return 100.0 * bound * len(times) / sum(times)
