"""FLOPs and bytes of Granite 4.0-H's work, from the configuration's
shapes (the published config's keys): what the requests need, not what
the program issues.

Per token and layer, outside the sequence mixing: a Mamba-2 layer's
in_proj and out_proj (2·d·(2·di + 2·N + H) and 2·di·d) and its depthwise
conv (2·W·(di + 2N)); an attention layer's projections (q and o
2·d·H·hd each, k and v 2·d·K·hd each); every layer's router (2·d·E), its
k routed experts' SwiGLU (three products of 2·d·f each) and the shared
expert's (three of 2·d·fs).  The sequence mixing: over a prompt, the
SSD (``counts/ssd.py``'s ``ssd_ops``) or the causal scores and their
weighted sum (a query at position p attends p + 1 keys, 4·H·hd·(p + 1));
a decode step, the SSD state update and C·S (4·H·P·N) or the scores
over the cache.  The tied head: 2·d·V.

A request of S prompt tokens that is served G tokens needs the prompt's
forward once and G - 1 decode steps (the first token comes from the
prompt's last position); the head runs at the prompt's last position
and at each decode step.

An MoE call's least work (``moe_flops``, ``moe_bytes``): the routed
rows' and the shared expert's products, and the weights of each expert
it touches and of the shared expert read once, with the routed and the
shared rows read in and written out once.
"""
from __future__ import annotations

from portbench.lib import common

_ssd = common.load_module("counts", "ssd")

BYTES = {"bfloat16": 2, "float32": 4}


def mamba_dims(cfg: dict):
    """(d, di, N, H, P, W)."""
    d = cfg["hidden_size"]
    return (d, cfg["mamba_expand"] * d, cfg["mamba_d_state"],
            cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_conv"])


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def expert_flops(cfg: dict) -> float:
    """One routed row through one expert's SwiGLU."""
    return 3 * 2.0 * cfg["hidden_size"] * cfg["intermediate_size"]


def shared_flops(cfg: dict) -> float:
    """One row through the shared expert's SwiGLU."""
    return 3 * 2.0 * cfg["hidden_size"] * cfg["shared_intermediate_size"]


def ffn_flops(cfg: dict) -> float:
    """Per token and layer: the router, the k experts, the shared one."""
    return (2.0 * cfg["hidden_size"] * cfg["num_local_experts"]
            + cfg["num_experts_per_tok"] * expert_flops(cfg)
            + shared_flops(cfg))


def mixer_flops(cfg: dict, kind: str) -> float:
    """Per token: a layer's projections (and a Mamba-2 layer's conv)."""
    if kind == "attention":
        return 2.0 * cfg["hidden_size"] * head_dim(cfg) * (
            2 * cfg["num_attention_heads"] + 2 * cfg["num_key_value_heads"])
    d, di, n, h, _, w = mamba_dims(cfg)
    return 2.0 * d * (2 * di + 2 * n + h) + 2.0 * di * d \
        + 2.0 * w * (di + 2 * n)


def score_flops(cfg: dict, first: int, last: int) -> float:
    """The causal scores and weighted sums of the queries at positions
    first..last - 1 (each attends every key up to itself)."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    return 4.0 * cfg["num_attention_heads"] * head_dim(cfg) * keys


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def request_flops(cfg: dict, prompt: int, generated: int) -> float:
    _, _, n, h, p, _ = mamba_dims(cfg)
    steps = generated - 1
    total = generated * head_flops(cfg)
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        per_token = mixer_flops(cfg, kind) + ffn_flops(cfg)
        total += (prompt + steps) * per_token
        if kind == "attention":
            total += score_flops(cfg, 0, prompt + steps)
        else:
            total += _ssd.ssd_ops(1, prompt, h, p, n,
                                  cfg["mamba_chunk_size"]) \
                + steps * 4.0 * h * p * n
    return total


def moe_flops(cfg: dict, routed_rows: int, shared_rows: int) -> float:
    return routed_rows * expert_flops(cfg) + shared_rows * shared_flops(cfg)


def moe_bytes(cfg: dict, routed_rows: int, experts_hit: int,
              shared_rows: int) -> float:
    b = BYTES[cfg["dtype"]]
    d = cfg["hidden_size"]
    weights = 3 * d * (experts_hit * cfg["intermediate_size"]
                       + (cfg["shared_intermediate_size"] if shared_rows
                          else 0))
    return b * (weights + 2 * (routed_rows + shared_rows) * d)
