"""Model FLOPs that Mamba-2 requests need, from the configuration's
shapes: what the requests need, not what the program issues.

A request of S prompt tokens that is served G tokens needs the prompt's
forward once and G - 1 decode steps (the first token comes from the
prompt's last position); the LM head runs at the prompt's last position
and at each decode step.  Per token and layer: in_proj and out_proj
(2·d·(2·di + 2·N + H) and 2·di·d), the depthwise conv (2·W·(di + 2N)),
and the SSD: over the prompt, ``counts.ssd.ssd_ops``; a decode step,
4·H·P·N (the state update and C·S).  The head: 2·d·V over the vocabulary
the requests draw from (the rows a program pads its table with are not
needed).
"""
from __future__ import annotations

from portbench.lib import common

_ssd = common.load_module("counts", "ssd")


def dims(cfg: dict):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    n, p = cfg["d_state"], cfg["head_dim"]
    return d, di, n, di // p, p


def token_flops(cfg: dict) -> float:
    """Per token and layer: the projections and the conv."""
    d, di, n, h, _ = dims(cfg)
    return (2.0 * d * (2 * di + 2 * n + h) + 2.0 * di * d
            + 2.0 * cfg["conv_width"] * (di + 2 * n))


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def request_flops(cfg: dict, prompt: int, generated: int) -> float:
    d, di, n, h, p = dims(cfg)
    layers = cfg["n_layer"]
    prefill = layers * (prompt * token_flops(cfg)
                        + _ssd.ssd_ops(1, prompt, h, p, n, cfg["chunk_size"]))
    decode = (generated - 1) * layers * (token_flops(cfg) + 4.0 * h * p * n)
    return prefill + decode + generated * head_flops(cfg)
