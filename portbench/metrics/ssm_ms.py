"""Device time of the traced serving round's Mamba-2 mixer calls: the
summed ``device_s`` of its ``ssm`` spans (in_proj, the conv, the SSD
scan, the gated norm and out_proj of each full-sequence call; decode
steps open none)."""
from portbench.lib import common


def read(ctx):
    return common.load_module("metrics", "edge_forward_ms").device_ms(
        ctx, "ssm")
