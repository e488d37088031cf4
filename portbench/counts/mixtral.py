"""FLOPs and bytes of Mixtral's work, from the configuration's shapes:
what the requests need, not what the program issues.

Per token and layer, outside the attention scores: the projections
(q and o 2·d·H·hd each, k and v 2·d·K·hd each), the router (2·d·E) and
the k routed experts' SwiGLU (three products of 2·d·f each).  The
causal scores and their weighted sum: a query at position p attends
p + 1 keys, 4·H·hd·(p + 1).  The LM head: 2·d·V.

A request of S prompt tokens that is served G tokens needs the prompt's
forward once and G - 1 decode steps (the first token comes from the
prompt's last position); the head runs at the prompt's last position
and at each decode step.

An MoE call's least work (``moe_flops``, ``moe_bytes``): the routed
rows' expert products, and the weights of each expert it touches read
once with its routed rows read in and written out once.
"""
from __future__ import annotations

BYTES = {"bfloat16": 2, "float32": 4}


def expert_flops(cfg: dict) -> float:
    """One routed row through one expert's SwiGLU."""
    return 3 * 2.0 * cfg["d_model"] * cfg["d_ff"]


def token_flops(cfg: dict) -> float:
    """Per token and layer: projections, router and the k experts."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    proj = 2.0 * d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    return (proj + 2.0 * d * cfg["n_experts"]
            + cfg["top_k"] * expert_flops(cfg))


def score_flops(cfg: dict, first: int, last: int) -> float:
    """The causal scores and weighted sums of the queries at positions
    first..last - 1 (each attends every key up to itself)."""
    keys = (last * (last + 1) - first * (first + 1)) // 2
    return 4.0 * cfg["n_heads"] * cfg["head_dim"] * keys


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def request_flops(cfg: dict, prompt: int, generated: int) -> float:
    layers = cfg["n_layers"]
    prefill = layers * (prompt * token_flops(cfg)
                        + score_flops(cfg, 0, prompt))
    decode = layers * ((generated - 1) * token_flops(cfg)
                       + score_flops(cfg, prompt, prompt + generated - 1))
    return prefill + decode + generated * head_flops(cfg)


def moe_flops(cfg: dict, routed_rows: int) -> float:
    return routed_rows * expert_flops(cfg)


def moe_bytes(cfg: dict, routed_rows: int, experts_hit: int) -> float:
    b = BYTES[cfg["dtype"]]
    d = cfg["d_model"]
    return b * (experts_hit * 3 * d * cfg["d_ff"] + 2 * routed_rows * d)
