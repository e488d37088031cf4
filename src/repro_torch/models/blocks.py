"""Residual block = (mixer, ffn) pair behind pre-norms, dispatched on the
layer spec.  Three entry points per block: ``forward`` (full sequence),
``prefill`` (forward + cache capture), ``decode`` (single token against a
cache).

Each branch's output is added to the residual stream times the
configuration's ``residual_multiplier`` (``_residual``; 1 for every
registry model, where no multiply is issued).

Mixers: attention and local attention (``attention``), the RG-LRU
(``rglru``) and the Mamba-2 SSD (``ssm``).  FFNs: dense (``ffn``) and the
mixture of experts (``moe``), whose router aux loss ``forward`` and
``prefill`` return and ``decode`` drops, as the JAX package's blocks do.
``constrain`` (the distributed layer's sharding hook, identity by
default) is handed to attention and the MoE, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (Params, dtype_of, laid_as,
                                       no_constrain, rms_norm, settled)


def init(generator, cfg, spec, device):
    mixer, ffn_kind = spec
    dt = dtype_of(cfg)
    norm = (lambda: torch.zeros((cfg.d_model,), dtype=dt, device=device)) \
        if cfg.gemma_style else \
        (lambda: torch.ones((cfg.d_model,), dtype=dt, device=device))
    p = {"norm1": norm()}
    if mixer in ("attn", "local"):
        p["mixer"] = attention.init(generator, cfg, device)
    elif mixer == "rec":
        p["mixer"] = rglru.init(generator, cfg, device)
    elif mixer == "ssd":
        p["mixer"] = ssm.init(generator, cfg, device)
    else:
        raise ValueError(mixer)
    if ffn_kind != "none":
        p["norm2"] = norm()
        p["ffn"] = (moe.init(generator, cfg, device) if ffn_kind == "moe"
                    else ffn_mod.init(generator, cfg, device))
    return Params(**p)


def _norm(cfg, x, w):
    """The pre-norm of a mixer or FFN input.  On a mesh its sequence is
    gathered whole (Megatron's sequence-parallel gather: the residual
    stream between blocks may be sequence-sharded, and a product over a
    batch- and sequence-sharded input is one DTensor cannot flatten)."""
    return settled(rms_norm(x, w, cfg.norm_eps, gemma_style=cfg.gemma_style),
                   whole=(1,))


def _residual(cfg, x, y):
    """x + y: a mixer's or FFN's output ``y`` added to the residual stream,
    times the configuration's ``residual_multiplier`` first where that is
    not 1 (no multiply is issued at 1)."""
    m = cfg.residual_multiplier
    return x + laid_as(y if m == 1.0 else y * m, x)


def _apply_ffn(params, cfg, spec, x, constrain=no_constrain):
    """Returns (y, aux); aux is the MoE balance loss, 0 for dense FFNs."""
    _, ffn_kind = spec
    if ffn_kind == "none":
        return x, 0.0
    h = _norm(cfg, x, params.norm2)
    if ffn_kind == "moe":
        y, aux = moe.forward(params.ffn, cfg, h, constrain=constrain)
    else:
        y, aux = ffn_mod.forward(params.ffn, cfg, h), 0.0
    return _residual(cfg, x, y), aux


def forward(params, cfg, spec, x, positions, impl="kernel",
            constrain=no_constrain):
    """(x, positions) -> (x, aux). Full sequence, no cache capture.
    ``impl`` picks the attention path (``attention.IMPLS``), the SSD
    scan (``"kernel"``, else the plain chunked scan: ``ssm``'s docstring)
    and the RG-LRU scan (``"kernel"``, else the plain associative scan:
    ``rglru``'s docstring)."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y = attention.forward(params.mixer, cfg, h, positions, mixer=mixer,
                              impl=impl, constrain=constrain)
    elif mixer == "rec":
        y, _ = rglru.forward(params.mixer, cfg, h, impl=impl)
    elif mixer == "ssd":
        y = ssm.forward(params.mixer, cfg, h, impl=impl)
    else:
        raise ValueError(mixer)
    return _apply_ffn(params, cfg, spec, _residual(cfg, x, y), constrain)


# --------------------------------------------------------------------------- #
# caches
# --------------------------------------------------------------------------- #
def init_cache(cfg, spec, batch, max_seq, dtype=None, *, device):
    mixer, _ = spec
    if mixer in ("attn", "local"):
        return attention.init_cache(cfg, batch, max_seq, mixer=mixer,
                                    dtype=dtype, device=device)
    if mixer == "rec":
        return rglru.init_cache(cfg, batch, dtype=dtype, device=device)
    if mixer == "ssd":
        return ssm.init_cache(cfg, batch, dtype=dtype, device=device)
    raise ValueError(mixer)


def prefill(params, cfg, spec, x, positions, max_seq, impl="kernel",
            constrain=no_constrain):
    """Like forward, but also returns the decode cache."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y, cache = attention.prefill(params.mixer, cfg, h, positions,
                                     max_seq, mixer=mixer, impl=impl,
                                     constrain=constrain)
    elif mixer == "rec":
        y, cache = rglru.prefill(params.mixer, cfg, h)
    elif mixer == "ssd":
        y, cache = ssm.prefill(params.mixer, cfg, h, impl=impl)
    else:
        raise ValueError(mixer)
    x, aux = _apply_ffn(params, cfg, spec, _residual(cfg, x, y), constrain)
    return x, cache, aux


def decode(params, cfg, spec, x, pos, cache, constrain=no_constrain):
    """Single-token step. x (B,1,D); pos: the absolute position, a 0-d
    int64 tensor on x's device (or an int).  The cache is updated in
    place and comes back as the same dict of the same tensors."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y, cache = attention.decode_step(params.mixer, cfg, h, pos, cache,
                                         mixer=mixer, constrain=constrain)
    elif mixer == "rec":
        y, cache = rglru.decode_step(params.mixer, cfg, h, cache)
    elif mixer == "ssd":
        y, cache = ssm.decode_step(params.mixer, cfg, h, cache)
    else:
        raise ValueError(mixer)
    x, _ = _apply_ffn(params, cfg, spec, _residual(cfg, x, y), constrain)
    return x, cache
