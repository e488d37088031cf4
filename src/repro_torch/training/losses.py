"""Next-token cross-entropy with vocab padding + ignore-index masking."""
from __future__ import annotations

import torch

IGNORE = -1


def cross_entropy(logits, labels, vocab_size):
    """logits (..., Vp) float32; labels (...) integers with ``IGNORE`` for
    masked positions (e.g. stub vision tokens).  Padded-vocab columns are
    excluded from the partition function.  The mean over valid
    positions."""
    vp = logits.shape[-1]
    if vp > vocab_size:
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def lm_loss(cfg, logits, labels):
    """Dispatch on architecture family.

    text/vlm: logits (B,S,Vp), labels (B,S)
    audio:    logits (B,S,K,V), labels (B,K,S) — mean over codebooks."""
    if cfg.n_codebooks > 1:
        return cross_entropy(logits, labels.transpose(1, 2), cfg.vocab_size)
    return cross_entropy(logits, labels, cfg.vocab_size)
