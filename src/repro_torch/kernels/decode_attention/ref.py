"""Plain PyTorch version of the decode-attention kernel.

Semantics: one new query token a row against a ring-buffer KV cache, with
native GQA.  q (B, 1, H, D); k/v (B, T, K, D) with H % K == 0, q head
``h`` reading kv head ``h // (H // K)``; ``slot_pos`` (T,) the absolute
position each ring slot holds (-1 where none); ``pos`` the query's
position, a 0-d tensor.  A slot is a key where ``0 <= slot_pos <= pos``
and, given a ``window``, ``slot_pos > pos - window``.

The same operations in the same order as the model's plain decode step
(``models.attention.decode_step`` off the card: ``_expand_kv`` then
``_sdpa``): the cache repeated across each group, the scores taken in the
inputs' dtype and scaled in float32, masked with the finite ``NEG_INF``,
softmaxed in float32, the probabilities back in the inputs' dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def decode_attention_ref(q, k, v, slot_pos, pos, *, window=0, scale=None):
    h, d = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    reps = h // k.shape[2]
    kf = k.repeat_interleave(reps, dim=2) if reps > 1 else k
    vf = v.repeat_interleave(reps, dim=2) if reps > 1 else v
    scores = torch.einsum("bshd,bthd->bhst", q, kf).float() * scale
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vf)
