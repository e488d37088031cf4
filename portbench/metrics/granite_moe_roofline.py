"""The granite cell's MoE calls' least time over their device time, in
the traced serving round: each ``moe`` span's least time is the larger
of its routed and shared-expert FLOPs at 989 TFLOP/s and the bytes of the
experts it touches, the shared expert's and its routed and shared rows
in and out at 3.35 TB/s (``counts/granite.py``, from the span's
``routed_rows``, ``experts_hit`` and ``shared_rows``), summed, over the
summed ``device_s`` of the spans."""
from portbench.lib import common


def read(ctx):
    tree = common.load_module("metrics", "admission_queue_wait_ms") \
        .traced_round(ctx, "serve.round")
    if tree is None:
        return None
    calls = [s for s in tree[1] if s.name == "moe"]
    if not calls or any(s.device_s is None or "shared_rows" not in s.fields
                        for s in calls):
        return None
    counts = common.load_module("counts", "granite")
    peaks = common.load_module("counts", "peaks")
    cfg = ctx["st"]["cfg"]
    need = 0.0
    for s in calls:
        f = s.fields
        need += max(counts.moe_flops(cfg, f["routed_rows"], f["shared_rows"])
                    / peaks.BF16_FLOPS_S,
                    counts.moe_bytes(cfg, f["routed_rows"], f["experts_hit"],
                                     f["shared_rows"]) / peaks.HBM_BYTES_S)
    return 100.0 * need / sum(s.device_s for s in calls)
