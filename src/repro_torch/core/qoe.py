"""QoE model (paper §II.C, eqs. 13–17).

Per-user QoE is a sigmoid of inference latency relative to the user's
threshold Q_i:

    R(x) = 1 / (1 + exp(-a (x - 1))),  x = T_i / Q_i

Delayed completion time (DCT):  C_i = (T_i − Q_i)·R(x)   (smooth eq. 14)
System metrics: C = Σ C_i (eq. 16), z = Σ R_i (eq. 17).  Sums run over
the last (user) axis, so a leading cell axis stays independent.
"""
from __future__ import annotations

import torch

DEFAULT_A = 50.0  # sigmoid sharpness; paper uses up to a=2000


def indicator(t, q, a=DEFAULT_A):
    """R_i(x) — smooth 'deadline exceeded' indicator."""
    x = t / q
    return torch.sigmoid(a * (x - 1.0))


def dct(t, q, a=DEFAULT_A):
    """Smooth delayed-completion time C'_i (eq. 14)."""
    return (t - q) * indicator(t, q, a)


def dct_exact(t, q):
    """Discrete C_i (eq. 13) — used for evaluation/metrics, not GD."""
    return torch.clamp_min(t - q, 0.0)


def system_qoe(t, q, a=DEFAULT_A):
    """Returns (C, z): summed smooth DCT and expected violating-user count."""
    r = indicator(t, q, a)
    return torch.sum((t - q) * r, dim=-1), torch.sum(r, dim=-1)


def round_indicator(r):
    """Paper's approximation rule: R < 1/2 -> 0 else 1."""
    return (r > 0.5).to(torch.float32)


def violations(t, q):
    """Hard metrics for evaluation: (#users with T>Q, Σ max(T-Q, 0))."""
    over = t > q
    return (torch.sum(over, dim=-1),
            torch.sum(torch.where(over, t - q, torch.zeros_like(t)), dim=-1))
