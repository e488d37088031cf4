"""Top-level decoder model: embedding (times ``embedding_multiplier``) ->
one block per layer -> final norm -> LM head (over ``logits_scaling``),
for every architecture of ``repro_torch.configs`` (attention,
local attention, RG-LRU and Mamba-2 SSD mixers; dense and
mixture-of-experts FFNs).

The model is a ``Params`` module: ``embed``, ``layers`` (an
``nn.ModuleList`` with one block per layer, where the JAX package stacks
the repeating pattern into scanned units plus a tail), ``final_norm`` and,
for untied embeddings, ``lm_head``.  ``forward`` still walks the layers a
pattern unit at a time (``cfg.pattern_len`` layers, then the tail), as the
JAX scan does: ``remat=True`` checkpoints each unit, and the MoE aux loss
sums per unit in JAX's order.

``constrain(x, name)`` is the distributed layer's sharding hook
(``distributed.sharding.ShardingRules.constrain``; names "resid" after
the embedding, after each unit and each tail layer, and "logits"), handed
down to the blocks; it defaults to the identity, so the model stays
mesh-agnostic.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.platform import resolve_device
from repro_torch.models import blocks
from repro_torch.models.common import (Params, dense_init, dtype_of,
                                       no_constrain, positions_for, rms_norm,
                                       settled)


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
    """tokens: (B,S) integers, or (B,K,S) for multi-codebook audio.  On a
    mesh, DTensor's lookup in a vocab-sharded table is a masked partial
    sum that it cannot move to another layout in one step: it is reduced
    over the vocab's axis here, and the caller's "resid" constraint cuts
    the result after."""
    tokens = tokens.long()
    if cfg.n_codebooks > 1:
        # sum codebook embeddings per step: tokens (B,K,S), embed (K,Vp,d)
        x = sum(F.embedding(tokens[:, k, :], params.embed[k])
                for k in range(cfg.n_codebooks))
    else:
        x = F.embedding(tokens, params.embed)             # (B,S,d)
    x = settled(x)
    if cfg.gemma_style:
        # the scale rounds to the embedding's dtype first, as in JAX
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def lm_logits(params, cfg, x, constrain=no_constrain):
    """Float32 logits (B,S,V), or (B,S,K,V) for multi-codebook heads,
    divided by the configuration's ``logits_scaling``: the head's input is
    divided (a pass over (B,S,d), not over the logits; for a power of two
    the same bits as dividing the logits)."""
    # the sequence whole on a mesh, as before each block's products
    x = settled(rms_norm(x, params.final_norm, cfg.norm_eps,
                         gemma_style=cfg.gemma_style), whole=(1,))
    if cfg.logits_scaling != 1.0:
        x = x / cfg.logits_scaling
    if cfg.n_codebooks > 1:
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,kvd->bskv", x, params.embed)
        else:
            logits = torch.einsum("bsd,kdv->bskv", x, params.lm_head)
    elif cfg.tie_embeddings:
        logits = torch.matmul(x, params.embed.t())
    else:
        logits = torch.matmul(x, params.lm_head)
    return constrain(logits.float(), "logits")


# --------------------------------------------------------------------------- #
# forward / prefill / decode
# --------------------------------------------------------------------------- #
def _stream(params, cfg, tokens, vision_embeds, positions):
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    if positions is None:
        positions = positions_for(cfg, x.shape[0], x.shape[1],
                                  device=x.device)
    return x, positions


def _run_layers(layers, cfg, specs, x, positions, impl,
                constrain=no_constrain):
    """One pattern unit's blocks in order. Returns (x, the sum of their
    MoE aux losses)."""
    aux = 0.0
    for spec, layer in zip(specs, layers):
        x, a = blocks.forward(layer, cfg, spec, x, positions, impl=impl,
                              constrain=constrain)
        aux = aux + a
    return constrain(x, "resid"), aux


def _ends_unit(cfg, i) -> bool:
    """Layer ``i`` closes a pattern unit, or is a tail layer: where JAX
    constrains the residual stream."""
    return i >= cfg.n_units * cfg.pattern_len or (i + 1) % cfg.pattern_len \
        == 0


def forward(params, cfg, tokens, vision_embeds=None, positions=None,
            impl="kernel", remat=False, constrain=no_constrain):
    """Full-sequence forward. Returns (logits, moe_aux).

    ``remat=True`` runs each pattern unit under ``torch.utils.checkpoint``
    (non-reentrant; the model draws no random numbers): the backward pass
    recomputes a unit's activations from its input, as
    ``jax.checkpoint(unit_body)`` does.  The tail layers stay outside."""
    x, positions = _stream(params, cfg, tokens, vision_embeds, positions)
    x = constrain(x, "resid")
    n, specs = cfg.pattern_len, cfg.layer_specs
    aux_total = 0.0
    for u in range(cfg.n_units):
        lo, hi = u * n, (u + 1) * n
        unit = (params.layers[lo:hi], cfg, specs[lo:hi], x, positions, impl,
                constrain)
        if remat:
            x, a = checkpoint(_run_layers, *unit, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _run_layers(*unit)
        aux_total = aux_total + a
    tail = cfg.n_units * n
    for spec, layer in zip(specs[tail:], params.layers[tail:]):
        x, a = blocks.forward(layer, cfg, spec, x, positions, impl=impl,
                              constrain=constrain)
        x = constrain(x, "resid")
        aux_total = aux_total + a
    return lm_logits(params, cfg, x, constrain), aux_total


def init_caches(cfg, batch, max_seq, dtype=None, *, device):
    """One decode cache per layer."""
    return [blocks.init_cache(cfg, spec, batch, max_seq, dtype=dtype,
                              device=device)
            for spec in cfg.layer_specs]


def prefill(params, cfg, tokens, max_seq, vision_embeds=None, positions=None,
            impl="kernel", constrain=no_constrain):
    """Full-sequence forward + decode-cache capture.

    Returns (logits, caches, aux)."""
    x, positions = _stream(params, cfg, tokens, vision_embeds, positions)
    x = constrain(x, "resid")
    aux_total, caches = 0.0, []
    for i, (spec, layer) in enumerate(zip(cfg.layer_specs, params.layers)):
        x, c, a = blocks.prefill(layer, cfg, spec, x, positions, max_seq,
                                 impl=impl, constrain=constrain)
        if _ends_unit(cfg, i):
            x = constrain(x, "resid")
        aux_total += a
        caches.append(c)
    return lm_logits(params, cfg, x, constrain), caches, aux_total


def decode_step(params, cfg, tokens, pos, caches, constrain=no_constrain):
    """One decode step.

    tokens: (B,) integers (or (B,K) for multi-codebook); pos: the absolute
    position of this token, a 0-d int64 tensor on the model's device (or
    an int).  Returns (logits (B, V...), caches); every cache is updated in
    place and comes back as the same tensors, and no value is read on the
    host (but by a capacity-bound MoE's dispatch), so one step can be
    captured in a CUDA graph and replayed at the position ``pos`` holds
    (``serving.engine``)."""
    if cfg.n_codebooks > 1:
        x = embed_tokens(params, cfg, tokens[:, :, None])    # (B,1,d)
    else:
        x = embed_tokens(params, cfg, tokens[:, None])
    x = constrain(x, "resid")
    new_caches = []
    for i, (spec, layer, cache) in enumerate(zip(cfg.layer_specs,
                                                 params.layers, caches)):
        x, c = blocks.decode(layer, cfg, spec, x, pos, cache,
                             constrain=constrain)
        if _ends_unit(cfg, i):
            x = constrain(x, "resid")
        new_caches.append(c)
    return lm_logits(params, cfg, x, constrain)[:, 0], new_caches
