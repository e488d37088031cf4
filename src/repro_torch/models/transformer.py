"""Top-level decoder model: embedding -> one block per layer -> final norm
-> LM head, for every architecture of ``repro_torch.configs`` (attention,
local attention, RG-LRU and Mamba-2 SSD mixers; dense and
mixture-of-experts FFNs).

The model is a ``Params`` module: ``embed``, ``layers`` (an
``nn.ModuleList`` with one block per layer, where the JAX package stacks
the repeating pattern into scanned units plus a tail), ``final_norm`` and,
for untied embeddings, ``lm_head``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.platform import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (Params, dense_init, dtype_of,
                                       positions_for, rms_norm)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init(generator: torch.Generator, cfg, device=None) -> Params:
    """Random weights from the host ``generator`` (each tensor seeds its
    own generator on ``device``), on ``device`` (default: the card; raises
    without one)."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model
    if cfg.n_codebooks > 1:
        embed = dense_init(generator, (cfg.n_codebooks, vp, d), dt, device,
                           in_axis_size=d)
    else:
        embed = dense_init(generator, (vp, d), dt, device, in_axis_size=d)
    p = {
        "embed": embed,
        "layers": nn.ModuleList(blocks.init(generator, cfg, spec, device)
                                for spec in cfg.layer_specs),
        "final_norm": (torch.zeros if cfg.gemma_style else torch.ones)(
            (d,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        shape = (cfg.n_codebooks, d, vp) if cfg.n_codebooks > 1 else (d, vp)
        p["lm_head"] = dense_init(generator, shape, dt, device)
    return Params(**p)


def param_count(params) -> int:
    return sum(x.numel() for x in params.parameters())


# --------------------------------------------------------------------------- #
# embedding / head
# --------------------------------------------------------------------------- #
def embed_tokens(params, cfg, tokens, vision_embeds=None):
    """tokens: (B,S) integers, or (B,K,S) for multi-codebook audio."""
    tokens = tokens.long()
    if cfg.n_codebooks > 1:
        # sum codebook embeddings per step: tokens (B,K,S), embed (K,Vp,d)
        x = sum(F.embedding(tokens[:, k, :], params.embed[k])
                for k in range(cfg.n_codebooks))
    else:
        x = F.embedding(tokens, params.embed)             # (B,S,d)
    if cfg.gemma_style:
        # the scale rounds to the embedding's dtype first, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def lm_logits(params, cfg, x):
    """Float32 logits (B,S,V), or (B,S,K,V) for multi-codebook heads."""
    x = rms_norm(x, params.final_norm, cfg.norm_eps,
                 gemma_style=cfg.gemma_style)
    if cfg.n_codebooks > 1:
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,kvd->bskv", x, params.embed)
        else:
            logits = torch.einsum("bsd,kdv->bskv", x, params.lm_head)
    elif cfg.tie_embeddings:
        logits = torch.matmul(x, params.embed.t())
    else:
        logits = torch.matmul(x, params.lm_head)
    return logits.float()


# --------------------------------------------------------------------------- #
# forward / prefill / decode
# --------------------------------------------------------------------------- #
def _stream(params, cfg, tokens, vision_embeds, positions):
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    if positions is None:
        positions = positions_for(cfg, x.shape[0], x.shape[1],
                                  device=x.device)
    return x, positions


def forward(params, cfg, tokens, vision_embeds=None, positions=None,
            impl="kernel"):
    """Full-sequence forward. Returns (logits, moe_aux)."""
    x, positions = _stream(params, cfg, tokens, vision_embeds, positions)
    aux_total = 0.0
    for spec, layer in zip(cfg.layer_specs, params.layers):
        x, a = blocks.forward(layer, cfg, spec, x, positions, impl=impl)
        aux_total += a
    return lm_logits(params, cfg, x), aux_total


def init_caches(cfg, batch, max_seq, dtype=None, *, device):
    """One decode cache per layer."""
    return [blocks.init_cache(cfg, spec, batch, max_seq, dtype=dtype,
                              device=device)
            for spec in cfg.layer_specs]


def prefill(params, cfg, tokens, max_seq, vision_embeds=None, positions=None,
            impl="kernel"):
    """Full-sequence forward + decode-cache capture.

    Returns (logits, caches, aux)."""
    x, positions = _stream(params, cfg, tokens, vision_embeds, positions)
    aux_total, caches = 0.0, []
    for spec, layer in zip(cfg.layer_specs, params.layers):
        x, c, a = blocks.prefill(layer, cfg, spec, x, positions, max_seq,
                                 impl=impl)
        aux_total += a
        caches.append(c)
    return lm_logits(params, cfg, x), caches, aux_total


def decode_step(params, cfg, tokens, pos, caches):
    """One decode step.

    tokens: (B,) integers (or (B,K) for multi-codebook); pos: the absolute
    position of this token.  Returns (logits (B, V...), caches); attention
    caches are updated in place."""
    if cfg.n_codebooks > 1:
        x = embed_tokens(params, cfg, tokens[:, :, None])    # (B,1,d)
    else:
        x = embed_tokens(params, cfg, tokens[:, None])
    new_caches = []
    for spec, layer, cache in zip(cfg.layer_specs, params.layers, caches):
        x, c = blocks.decode(layer, cfg, spec, x, pos, cache)
        new_caches.append(c)
    return lm_logits(params, cfg, x)[:, 0], new_caches
