"""Split-inference runtime — the execution layer underneath ERA.

The model is cut at block boundary ``s``: the *device side* runs
embedding + blocks[0:s]; the *edge side* runs blocks[s:F] + final norm +
LM head.  The tensor that crosses the (simulated) NOMA link is the residual
stream (B,S,d) (+ recurrent state bytes for rec/ssd blocks — see
core.profiles).
"""
from __future__ import annotations

from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.models.common import positions_for


def layer_params(params, cfg, i):
    """Block i's weights and its (mixer, ffn) spec."""
    return params.layers[i], cfg.layer_specs[i]


def forward_range(params, cfg, x, positions, start: int, end: int,
                  impl="kernel"):
    """Apply blocks [start, end) to the residual stream x."""
    for i in range(start, end):
        p_i, spec = layer_params(params, cfg, i)
        x, _ = blocks.forward(p_i, cfg, spec, x, positions, impl=impl)
    return x


def device_forward(params, cfg, tokens, split: int, vision_embeds=None,
                   positions=None, impl="kernel"):
    """Device side: embed + blocks[0:split]. Returns the crossing tensor
    and the positions."""
    x = T.embed_tokens(params, cfg, tokens, vision_embeds)
    if positions is None:
        positions = positions_for(cfg, x.shape[0], x.shape[1],
                                  device=x.device)
    x = forward_range(params, cfg, x, positions, 0, split, impl=impl)
    return x, positions


def edge_forward(params, cfg, x, positions, split: int, impl="kernel"):
    """Edge side: blocks[split:F] + head. Returns logits."""
    x = forward_range(params, cfg, x, positions, split, cfg.n_layers,
                      impl=impl)
    return T.lm_logits(params, cfg, x)


def split_inference(params, cfg, tokens, split: int, vision_embeds=None,
                    impl="kernel"):
    """Full split pipeline (reference path; the engine adds the channel).

    Returns (logits, crossing_bits)."""
    x, positions = device_forward(params, cfg, tokens, split,
                                  vision_embeds=vision_embeds, impl=impl)
    crossing_bits = float(x.numel()) * x.element_size() * 8
    logits = edge_forward(params, cfg, x, positions, split, impl=impl)
    return logits, crossing_bits
