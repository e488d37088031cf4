"""Next-token cross-entropy with vocab padding + ignore-index masking."""
from __future__ import annotations

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

IGNORE = -1


def cross_entropy(logits, labels, vocab_size):
    """logits (..., Vp) float32; labels (...) integers with ``IGNORE`` for
    masked positions (e.g. stub vision tokens).  Padded-vocab columns are
    excluded from the partition function.  The mean over valid
    positions.

    On a mesh (DTensor logits, the vocab sharded) the column ids are laid
    out as the logits' last dim, the partition function is taken from its
    parts (max, exp-sum, log: DTensor's logsumexp gathers the vocab), and
    the gold logit is a masked sum over the vocab — exact, one term is not
    zero — where one device gathers: a gather's backward would allocate
    the whole global logits on every rank."""
    vp = logits.shape[-1]
    cols = torch.arange(vp, device=logits.device)
    if isinstance(logits, DTensor):
        last = Shard(logits.ndim - 1)
        cols = distribute_tensor(
            cols, logits.device_mesh,
            [Shard(0) if p == last else Replicate()
             for p in logits.placements],
            src_data_rank=None)
    if vp > vocab_size:
        logits = logits.masked_fill(cols >= vocab_size, -1e30)
    valid = labels != IGNORE
    safe = torch.where(valid, labels, 0).long()
    if isinstance(logits, DTensor):
        # DTensor's logsumexp gathers the vocab; its parts do not
        m = torch.amax(logits, dim=-1, keepdim=True).detach()
        logz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
        gold = torch.where(cols == safe[..., None], logits, 0.0).sum(-1)
    else:
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
