"""Split-inference runtime — the execution layer underneath ERA.

The model is cut at block boundary ``s``: the *device side* runs
embedding + blocks[0:s]; the *edge side* runs blocks[s:F] + final norm +
LM head.  The tensor that crosses the (simulated) NOMA link is the residual
stream (B,S,d) (+ recurrent state bytes for rec/ssd blocks — see
core.profiles).

Given ``caches`` (a list) and ``max_seq``, ``forward_range``,
``device_forward`` and ``split_inference`` capture decode caches on the
way: each block runs ``blocks.prefill``, ``blocks.forward``'s computation
plus the block's decode cache for ``max_seq`` positions, and appends that
cache to ``caches``.  A Mamba-2 block still refuses a sequence that is not
a whole number of SSD chunks, as ``blocks.forward`` does.
"""
from __future__ import annotations

from repro_torch.models import blocks, ssm
from repro_torch.models import transformer as T
from repro_torch.models.common import positions_for


def layer_params(params, cfg, i):
    """Block i's weights and its (mixer, ffn) spec."""
    return params.layers[i], cfg.layer_specs[i]


def forward_range(params, cfg, x, positions, start: int, end: int,
                  impl="kernel", max_seq=None, caches=None):
    """Apply blocks [start, end) to the residual stream x (given
    ``caches``, each block's decode cache is appended to it)."""
    for i in range(start, end):
        p_i, spec = layer_params(params, cfg, i)
        if caches is None:
            x, _ = blocks.forward(p_i, cfg, spec, x, positions, impl=impl)
            continue
        if spec[0] == "ssd":
            ssm.check_whole_chunks(cfg, x.shape[1])
        x, cache, _ = blocks.prefill(p_i, cfg, spec, x, positions, max_seq,
                                     impl=impl)
        caches.append(cache)
    return x


def device_forward(params, cfg, tokens, split: int, vision_embeds=None,
                   positions=None, impl="kernel", max_seq=None, caches=None):
    """Device side: embed + blocks[0:split]. Returns the crossing tensor
    and the positions."""
    x = T.embed_tokens(params, cfg, tokens, vision_embeds)
    if positions is None:
        positions = positions_for(cfg, x.shape[0], x.shape[1],
                                  device=x.device)
    x = forward_range(params, cfg, x, positions, 0, split, impl=impl,
                      max_seq=max_seq, caches=caches)
    return x, positions


def edge_forward(params, cfg, x, positions, split: int, impl="kernel"):
    """Edge side: blocks[split:F] + head. Returns logits."""
    x = forward_range(params, cfg, x, positions, split, cfg.n_layers,
                      impl=impl)
    return T.lm_logits(params, cfg, x)


def split_inference(params, cfg, tokens, split: int, vision_embeds=None,
                    impl="kernel", max_seq=None, caches=None):
    """Full split pipeline (the engine adds the channel).

    Returns (logits, crossing_bits).  The edge side is ``edge_forward``'s,
    run here on the one reference to the crossing tensor, so that the
    tensor is let go before the head, whose logits are a serve round's
    peak of memory."""
    x, positions = device_forward(params, cfg, tokens, split,
                                  vision_embeds=vision_embeds, impl=impl,
                                  max_seq=max_seq, caches=caches)
    crossing_bits = float(x.numel()) * x.element_size() * 8
    x = forward_range(params, cfg, x, positions, split, cfg.n_layers,
                      impl=impl, max_seq=max_seq, caches=caches)
    return T.lm_logits(params, cfg, x), crossing_bits
