"""The ssd kernel's least time at each of the granite cell's calls (the
larger of its byte bound at 3.35 TB/s and its operation bound at 989
TFLOP/s, ``counts/ssd.py`` at the configuration's Mamba-2 shape) over the
device time of its three launches, summed over the calls in the traced
stretch (one whole round, whose calls the runner lays out in order:
``ssd_rows``)."""
from portbench.lib import common
from portbench.lib.trace import calls

SSD_LAUNCHES = ("ssd_states_kernel", "ssd_pass_kernel", "ssd_out_kernel")


def read(ctx):
    tr, st, path = ctx["trace"], ctx["st"], ctx["path"]
    if tr is None or not hasattr(path, "ssd_rows"):
        return None
    times = calls(tr["kernels"], SSD_LAUNCHES)
    rows = path.ssd_rows(st)
    if not times or not rows:
        return None
    counts = common.load_module("counts", "ssd")
    peaks = common.load_module("counts", "peaks")
    cfg, mix = st["cfg"], st["mix"]
    rows = (rows * (len(times) // len(rows) + 1))[:len(times)]
    need = 0.0
    for b in rows:
        shape = (b, mix["prompt_len"], cfg["mamba_n_heads"],
                 cfg["mamba_d_head"], cfg["mamba_d_state"])
        need += max(counts.ssd_bytes(*shape) / peaks.HBM_BYTES_S,
                    counts.ssd_ops(*shape, cfg["mamba_chunk_size"])
                    / peaks.BF16_FLOPS_S)
    return 100.0 * need / sum(times)
