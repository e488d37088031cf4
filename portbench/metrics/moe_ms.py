"""Device time of the traced serving round's MoE calls: the summed
``device_s`` of its ``moe`` spans (routing, the expert products and the
combine, in the split groups' forward and in decode)."""
from portbench.lib import common


def read(ctx):
    return common.load_module("metrics", "edge_forward_ms").device_ms(
        ctx, "moe")
