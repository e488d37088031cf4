"""The ssd kernel's least time at each call's shape (the larger of its
byte bound at 3.35 TB/s and its operation bound at 989 TFLOP/s,
``counts/ssd.py``) over the device time of its three launches, summed
over the calls in the traced stretch (one whole round, whose calls the
runner lays out in order: ``ssd_rows``)."""
from portbench.lib import common
from portbench.lib.trace import calls

SSD_LAUNCHES = ("ssd_states_kernel", "ssd_pass_kernel", "ssd_out_kernel")


def read(ctx):
    tr, st = ctx["trace"], ctx["st"]
    if tr is None:
        return None
    times = calls(tr["kernels"], SSD_LAUNCHES)
    if not times:
        return None
    counts = common.load_module("counts", "ssd")
    peaks = common.load_module("counts", "peaks")
    model, mix = st["cfg"]["model"], st["mix"]
    h = model["expand"] * model["d_model"] // model["head_dim"]
    rows = ctx["path"].ssd_rows(st)
    rows = (rows * (len(times) // len(rows) + 1))[:len(times)]
    need = 0.0
    for b in rows:
        shape = (b, mix["prompt_len"], h, model["head_dim"], model["d_state"])
        need += max(counts.ssd_bytes(*shape) / peaks.HBM_BYTES_S,
                    counts.ssd_ops(*shape, model["chunk_size"])
                    / peaks.BF16_FLOPS_S)
    return 100.0 * need / sum(times)
