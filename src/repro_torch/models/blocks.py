"""Residual block = (mixer, ffn) pair behind pre-norms, dispatched on the
layer spec.  Three entry points per block: ``forward`` (full sequence),
``prefill`` (forward + cache capture), ``decode`` (single token against a
cache).

Mixers: attention and local attention (``attention``), the RG-LRU
(``rglru``) and the Mamba-2 SSD (``ssm``).  FFNs: dense (``ffn``) and the
mixture of experts (``moe``), whose router aux loss ``forward`` and
``prefill`` return and ``decode`` drops, as the JAX package's blocks do.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import Params, dtype_of, rms_norm


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
    return rms_norm(x, w, cfg.norm_eps, gemma_style=cfg.gemma_style)


def _apply_ffn(params, cfg, spec, x):
    """Returns (y, aux); aux is the MoE balance loss, 0 for dense FFNs."""
    _, ffn_kind = spec
    if ffn_kind == "none":
        return x, 0.0
    h = _norm(cfg, x, params.norm2)
    if ffn_kind == "moe":
        y, aux = moe.forward(params.ffn, cfg, h)
    else:
        y, aux = ffn_mod.forward(params.ffn, cfg, h), 0.0
    return x + y, aux


def forward(params, cfg, spec, x, positions, impl="kernel"):
    """(x, positions) -> (x, aux). Full sequence, no cache capture.
    ``impl`` picks the attention path (``attention.IMPLS``) and the SSD
    scan (``"kernel"``, else the plain chunked scan: ``ssm``'s
    docstring); the RG-LRU mixer has one path (``rglru``'s docstring)."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y = attention.forward(params.mixer, cfg, h, positions, mixer=mixer,
                              impl=impl)
    elif mixer == "rec":
        y, _ = rglru.forward(params.mixer, cfg, h)
    elif mixer == "ssd":
        y = ssm.forward(params.mixer, cfg, h, impl=impl)
    else:
        raise ValueError(mixer)
    return _apply_ffn(params, cfg, spec, x + y)


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


def prefill(params, cfg, spec, x, positions, max_seq, impl="kernel"):
    """Like forward, but also returns the decode cache."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y, cache = attention.prefill(params.mixer, cfg, h, positions,
                                     max_seq, mixer=mixer, impl=impl)
    elif mixer == "rec":
        y, cache = rglru.prefill(params.mixer, cfg, h)
    elif mixer == "ssd":
        y, cache = ssm.prefill(params.mixer, cfg, h, impl=impl)
    else:
        raise ValueError(mixer)
    x, aux = _apply_ffn(params, cfg, spec, x + y)
    return x, cache, aux


def decode(params, cfg, spec, x, pos, cache):
    """Single-token step. x (B,1,D); pos: the absolute position (int)."""
    mixer, _ = spec
    h = _norm(cfg, x, params.norm1)
    if mixer in ("attn", "local"):
        y, cache = attention.decode_step(params.mixer, cfg, h, pos, cache,
                                         mixer=mixer)
    elif mixer == "rec":
        y, cache = rglru.decode_step(params.mixer, cfg, h, cache)
    elif mixer == "ssd":
        y, cache = ssm.decode_step(params.mixer, cfg, h, cache)
    else:
        raise ValueError(mixer)
    x, _ = _apply_ffn(params, cfg, spec, x + y)
    return x, cache
