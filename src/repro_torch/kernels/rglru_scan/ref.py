"""Plain PyTorch versions of the gated linear recurrence
h_t = a_t ⊙ h_{t-1} + b_t.

Two: an O(L) sequential scan (ground truth, and the kernel's plain
version: the same multiply, then add, per step) and an O(log L)
associative scan, the counterpart of the JAX model's
``jax.lax.associative_scan`` path.
"""
from __future__ import annotations

import torch


def linear_scan_sequential(a, b, h0=None):
    """a, b: (B, L, D). Returns h (B, L, D)."""
    bt, l, d = a.shape
    h = torch.zeros((bt, d), dtype=a.dtype, device=a.device) if h0 is None \
        else h0
    out = torch.empty_like(a)
    for t in range(l):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def linear_scan_associative(a, b):
    """Hillis–Steele inclusive scan of the pairs (a, b) under
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2), along axis 1."""
    l = a.shape[1]
    shift = 1
    while shift < l:
        a_prev = torch.ones_like(a)
        b_prev = torch.zeros_like(b)
        a_prev[:, shift:] = a[:, :-shift]
        b_prev[:, shift:] = b[:, :-shift]
        a, b = a_prev * a, a * b_prev + b
        shift *= 2
    return b
