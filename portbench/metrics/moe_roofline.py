"""The MoE calls' least time over their device time, in the traced
serving round: each ``moe`` span's least time is the larger of its
routed FLOPs at 989 TFLOP/s and the bytes of the experts it touches plus
its routed rows in and out at 3.35 TB/s (``counts/mixtral.py``, from the
span's ``routed_rows`` and ``experts_hit``), summed, over the summed
``device_s`` of the spans."""
from portbench.lib import common


def read(ctx):
    tree = common.load_module("metrics", "admission_queue_wait_ms") \
        .traced_round(ctx, "serve.round")
    if tree is None:
        return None
    calls = [s for s in tree[1] if s.name == "moe"]
    if not calls or any(s.device_s is None for s in calls):
        return None
    counts = common.load_module("counts", "mixtral")
    peaks = common.load_module("counts", "peaks")
    model = ctx["st"]["cfg"]["model"]
    need = sum(max(counts.moe_flops(model, s.fields["routed_rows"])
                   / peaks.BF16_FLOPS_S,
                   counts.moe_bytes(model, s.fields["routed_rows"],
                                    s.fields["experts_hit"])
                   / peaks.HBM_BYTES_S) for s in calls)
    return 100.0 * need / sum(s.device_s for s in calls)
