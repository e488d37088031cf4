"""Device time of the traced serving round's decode loops: the summed
``device_s`` of its ``serve.decode`` spans (the greedy steps after the
prefill and the tokens' copy to the host)."""
from portbench.lib import common


def read(ctx):
    return common.load_module("metrics", "edge_forward_ms").device_ms(
        ctx, "serve.decode")
