"""ERA utility: inference delay (eq. 12), energy (eq. 22), QoE terms
(16,17) and the weighted objective Γ (eqs. 24–27).

Variables per user i (paper §II.E):
  s_i      split point               — discrete, handled by the Li-GD layer loop
  β_up/β_dn subchannel assignment    — relaxed to [0,1]^{U×M} (Corollary 1)
  p_i      device uplink tx power    — continuous in [p_min, p_max]
  P_i      AP downlink power share   — continuous in [P_min, P_max]
  r_i      edge compute units        — continuous in [r_min, r_max]

Every function takes one cell or a batch with a leading cell axis; the Σ
reductions run over the user axis only, so cells stay independent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import noma, qoe
from repro_torch.core.network import env_col
from repro_torch.core.profiles import take_split


class Allocation(NamedTuple):
    beta_up: torch.Tensor  # (U, M)
    beta_dn: torch.Tensor  # (U, M)
    p: torch.Tensor        # (U,)
    p_ap: torch.Tensor     # (U,)
    r: torch.Tensor        # (U,)


@dataclass(frozen=True)
class Weights:
    """ω_T + ω_Q + ω_R = 1 (eq. 24)."""
    w_t: float = 0.4
    w_q: float = 0.3
    w_r: float = 0.3
    qoe_a: float = qoe.DEFAULT_A
    # scale normalisers so the three addends are commensurate
    t_scale: float = 1.0       # seconds -> utility units
    e_scale: float = 1.0
    r_cost_scale: float = 0.01


def lam(r, env):
    """λ(r) = r^a: effective compute multiple of r allocated units.
    ``env`` is a ``CellEnv`` (or anything with ``lambda_exponent``)."""
    return r ** env_col(env.lambda_exponent, r)


def uniform_alloc(scn, generator: torch.Generator = None):
    """Feasible uninformed starting point (paper Table I line 1)."""
    cfg, env = scn.cfg, scn.env
    u, m = cfg.n_users, cfg.n_subchannels
    lead = tuple(scn.assoc.shape[:-1])
    dev = scn.device
    if generator is not None:
        b_up = torch.rand(lead + (u, m), generator=generator).to(dev)
        b_dn = torch.rand(lead + (u, m), generator=generator).to(dev)
        b_up = b_up / b_up.sum(-1, keepdim=True)
        b_dn = b_dn / b_dn.sum(-1, keepdim=True)
    else:
        b_up = torch.full(lead + (u, m), 1.0 / m, device=dev)
        b_dn = torch.full(lead + (u, m), 1.0 / m, device=dev)

    def mid(lo, hi):
        return (0.5 * (lo + hi))[..., None].expand(lead + (u,)).clone()

    return Allocation(b_up, b_dn, mid(env.p_min_w, env.p_max_w),
                      mid(env.ap_p_min_w, env.ap_p_max_w),
                      mid(env.r_min, env.r_max))


def delay_terms(scn, prof, s, alloc):
    """Per-user (T_device, T_server, T_up, T_down, R_up, R_dn).

    ``s``: (U,) int64 split points in {0..F}."""
    env = scn.env
    dev_fl = take_split(prof.device_flops, s)
    edge_fl = take_split(prof.edge_flops, s)
    w_up = take_split(prof.uplink_bits, s)
    w_dn = take_split(prof.downlink_bits, s)

    r_up = noma.uplink_rates(scn, alloc.beta_up, alloc.p)
    r_dn = noma.downlink_rates(scn, alloc.beta_dn, alloc.p_ap)

    one = torch.ones((), dtype=r_up.dtype, device=r_up.device)
    t_dev = dev_fl / env_col(env.c_device_flops, dev_fl)
    t_srv = edge_fl / (lam(alloc.r, env) * env_col(env.c_min_flops, edge_fl))
    t_up = w_up / torch.maximum(r_up, one)
    t_dn = w_dn / torch.maximum(r_dn, one)
    return t_dev, t_srv, t_up, t_dn, r_up, r_dn


def energy(scn, prof, s, alloc, r_up, r_dn):
    """Per-user energy E_i (eq. 22), joules: E = ξ · c² · f."""
    env = scn.env
    dev_fl = take_split(prof.device_flops, s)
    edge_fl = take_split(prof.edge_flops, s)
    w_up = take_split(prof.uplink_bits, s)
    w_dn = take_split(prof.downlink_bits, s)
    col = lambda v: env_col(v, dev_fl)
    one = torch.ones((), dtype=r_up.dtype, device=r_up.device)

    e_dev = col(env.xi_device) * (col(env.c_device_flops) ** 2) * dev_fl
    edge_c = lam(alloc.r, env) * col(env.c_min_flops)
    e_edge = col(env.xi_edge) * (edge_c ** 2) * edge_fl
    e_up = alloc.p * w_up / torch.maximum(r_up, one)
    e_dn = alloc.p_ap * w_dn / torch.maximum(r_dn, one)
    return e_dev + e_edge + e_up + e_dn


class Terms(NamedTuple):
    t: torch.Tensor        # (U,) latency
    e: torch.Tensor        # (U,) energy
    c: torch.Tensor        # scalar smooth ΣDCT
    z: torch.Tensor        # scalar expected violators
    gamma: torch.Tensor    # scalar utility Γ


def utility(scn, prof, s, alloc, q_thresh, w: Weights) -> Terms:
    """Γ = ω_T ΣT + ω_Q (C + z) + ω_R (ΣE + Σλ(r))   (eqs. 24–27).

    q_thresh: (U,) per-user QoE latency thresholds Q_i (seconds)."""
    t_dev, t_srv, t_up, t_dn, r_up, r_dn = delay_terms(scn, prof, s, alloc)
    t = t_dev + t_srv + t_up + t_dn
    e = energy(scn, prof, s, alloc, r_up, r_dn)
    c, z = qoe.system_qoe(t, q_thresh, w.qoe_a)
    gamma = (w.w_t * torch.sum(t, dim=-1) * w.t_scale
             + w.w_q * (c * w.t_scale + z)
             + w.w_r * (torch.sum(e, dim=-1) * w.e_scale
                        + torch.sum(lam(alloc.r, scn.env), dim=-1)
                        * w.r_cost_scale))
    return Terms(t, e, c, z, gamma)


def clip_alloc(scn, alloc: Allocation) -> Allocation:
    """Projection onto the feasible box + β row-simplex (Σ_m β = 1)."""
    env = scn.env

    def simplex(b):
        b = torch.clamp(b, 0.0, 1.0)
        return b / torch.clamp_min(b.sum(dim=-1, keepdim=True), 1e-9)

    def box(x, lo, hi):
        return torch.clamp(x, env_col(lo, x), env_col(hi, x))

    return Allocation(
        beta_up=simplex(alloc.beta_up),
        beta_dn=simplex(alloc.beta_dn),
        p=box(alloc.p, env.p_min_w, env.p_max_w),
        p_ap=box(alloc.p_ap, env.ap_p_min_w, env.ap_p_max_w),
        r=box(alloc.r, env.r_min, env.r_max),
    )


def round_beta(scn, alloc: Allocation, cap=None) -> Allocation:
    """Discretise β to one-hot (paper Table I line 19), honouring the
    ≤ max_users_per_channel cap per (AP, channel) greedily.

    Host-side NumPy by design — the greedy cap is sequential — and kept
    call-for-call with the JAX package's (same ``np.argsort`` calls), so
    near-ties round the same way.  One cell only."""
    cfg = scn.cfg
    cap = cfg.max_users_per_channel if cap is None else cap
    assoc = scn.assoc.cpu().numpy()

    def harden(beta):
        b = beta.detach().cpu().numpy()
        u, m = b.shape
        counts = {}
        hard = np.zeros_like(b)
        # strongest preference first
        order = np.argsort(-b.max(axis=1))
        for i in order:
            for ch in np.argsort(-b[i]):
                key = (int(assoc[i]), int(ch))
                if counts.get(key, 0) < cap:
                    counts[key] = counts.get(key, 0) + 1
                    hard[i, ch] = 1.0
                    break
        return torch.as_tensor(hard, device=beta.device)

    return alloc._replace(beta_up=harden(alloc.beta_up),
                          beta_dn=harden(alloc.beta_dn))
