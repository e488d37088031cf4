"""Device time of the traced serving round's decode prefills: the summed
``device_s`` of its ``serve.prefill`` spans (``engine._continue_decode``'s
``transformer.prefill``, which runs each prompt a second time)."""
from portbench.lib import common


def read(ctx):
    return common.load_module("metrics", "edge_forward_ms").device_ms(
        ctx, "serve.prefill")
