"""The flash-attention kernel's operation bound at each call's shape
(``counts/flash.py``: causal, 2·B·H·D·S², at 989 TFLOP/s) over the device
time of its launches (``flash_wg_kernel``, the bf16 kernel) in the
traced stretch, one whole round, whose calls the runner lays out in
order (``flash_calls``)."""
from portbench.lib import common

FLASH_LAUNCH = "flash_wg_kernel"


def read(ctx):
    tr, st, path = ctx["trace"], ctx["st"], ctx["path"]
    if tr is None or not hasattr(path, "flash_calls"):
        return None
    times = [(e - s) / 1e6 for s, e, name in tr["kernels"]
             if name == FLASH_LAUNCH]
    shapes = path.flash_calls(st)
    if not times or not shapes:
        return None
    counts = common.load_module("counts", "flash")
    peaks = common.load_module("counts", "peaks")
    model = st["cfg"]["model"]
    shapes = (shapes * (len(times) // len(shapes) + 1))[:len(times)]
    need = sum(counts.flash_ops(b, s, model["n_heads"], model["head_dim"])
               for b, s in shapes) / peaks.BF16_FLOPS_S
    return 100.0 * need / sum(times)
