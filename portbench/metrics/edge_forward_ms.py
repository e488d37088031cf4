"""Device time of the traced serving round's split groups: the summed
``device_s`` of its ``serve.split_group`` spans (each group's device
and edge forward, float32 logits and all, and its first token's copy).

``device_ms`` serves the round's other span readers."""
from portbench.lib import common


def device_ms(ctx, name):
    """Summed ``device_s`` of the traced ``serve.round``'s spans named
    ``name``, in ms, or None."""
    tree = common.load_module("metrics", "admission_queue_wait_ms") \
        .traced_round(ctx, "serve.round")
    if tree is None:
        return None
    got = [s.device_s for s in tree[1] if s.name == name]
    if not got or any(t is None for t in got):
        return None
    return 1e3 * sum(got)


def read(ctx):
    return device_ms(ctx, "serve.split_group")
