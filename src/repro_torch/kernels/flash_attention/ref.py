"""Plain PyTorch version of the flash-attention kernel.

Semantics: causal self-attention with optional sliding window and native
GQA (q heads grouped onto kv heads).  Layout matches the model substrate:
q (B,S,H,D), k/v (B,T,K,D) with H % K == 0.  Scores are taken in the
inputs' dtype, then softmaxed in float32 with the finite ``NEG_INF``
sentinel on masked entries, as the JAX package's oracle does.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    b, s, h, d = q.shape
    t, kheads = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    reps = h // kheads
    kf = k.repeat_interleave(reps, dim=2) if reps > 1 else k
    vf = v.repeat_interleave(reps, dim=2) if reps > 1 else v
    scores = torch.einsum("bshd,bthd->bhst", q, kf).float() * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, vf)
