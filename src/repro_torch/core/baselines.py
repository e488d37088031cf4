"""Baseline split/offloading algorithms the paper compares against (§V.A):

  Device-Only   — whole model on the device (s = F)
  Edge-Only     — whole model on the edge (s = 0)
  Neurosurgeon  — per-user latency-minimal split under fixed, equal resource
                  allocation [Kang et al., ASPLOS'17]
  DNN-Surgery   — latency-minimal split + latency-only GD over (p, P, r)
                  [Liang et al., TCC'23]
  IAO           — joint split + resource allocation minimising latency and
                  energy, no QoE term [Tang et al., IoT-J'21]
  DINA          — adaptive fine-grained offloading heuristic: minimise the
                  transferred intermediate data, then allocate resources
                  proportionally to offloaded load [Mohammed et al.,
                  INFOCOM'20]

All baselines are scored through the same ``era.utility`` as ERA, so the
comparison is like for like; none of them sees the QoE term (that is the
paper's point).  DNN-Surgery's and IAO's GD runs the port's ``fused``
step (the era_step kernel on the card) unless ``step_impl`` names
``autograd``.

Ties: where a baseline picks the smallest latency or the fewest bits, it
takes the lower split index among equal values, as ``jnp.argmin`` does.
``torch.argmin`` on a CUDA tensor promises no such order, so the picks
run ``np.argmin`` (first occurrence) on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ligd, noma
from repro_torch.core.era import (Allocation, Terms, Weights, delay_terms,
                                  round_beta, uniform_alloc, utility)


class BaselineOutcome(NamedTuple):
    name: str
    s: np.ndarray
    alloc: Allocation
    terms: Terms
    iters: int = 0        # GD iterations the baseline ran (0: no GD)


def default_alloc(scn, *, power_frac=1.0, r_frac=0.5) -> Allocation:
    """Fixed allocation used by non-optimising baselines: round-robin
    least-loaded subchannel per AP (≤ cap users/channel), max power,
    equal compute share."""
    cfg = scn.cfg
    u = cfg.n_users
    dev = scn.device
    soft = uniform_alloc(scn)
    full = lambda v: torch.full((u,), v, dtype=torch.float32, device=dev)
    p = full(cfg.p_min_w + power_frac * (cfg.p_max_w - cfg.p_min_w))
    p_ap = full(cfg.ap_p_min_w
                + power_frac * (cfg.ap_p_max_w - cfg.ap_p_min_w))
    r = full(cfg.r_min + r_frac * (cfg.r_max - cfg.r_min))
    alloc = Allocation(soft.beta_up, soft.beta_dn, p, p_ap, r)
    # harden β by best-gain-first greedy (round_beta uses β magnitudes;
    # seed them with the channel gains so "best channel first" wins)
    gain_up = scn.own_gain_up()
    gain_dn = scn.own_gain_dn()
    alloc = alloc._replace(beta_up=gain_up / gain_up.max(),
                           beta_dn=gain_dn / gain_dn.max())
    return round_beta(scn, alloc)


def _split_vec(s, scn):
    return torch.as_tensor(np.asarray(s), dtype=torch.int64,
                           device=scn.device)


def _finish(scn, prof, name, s_user, alloc, q, w) -> BaselineOutcome:
    q = torch.as_tensor(q, dtype=torch.float32, device=scn.device)
    feasible = noma.sic_feasible(scn, alloc.beta_up, alloc.p)
    s_final = torch.where(feasible, s_user,
                          torch.full_like(s_user, prof.n_layers))
    terms = utility(scn, prof, s_final, alloc, q, w)
    return BaselineOutcome(name, s_final.cpu().numpy(), alloc, terms)


def _latency_table(scn, prof, alloc):
    """(F+1, U) per-user latency for every split under ``alloc``."""
    u = scn.cfg.n_users
    rows = []
    for s in range(prof.n_layers + 1):
        s_vec = torch.full((u,), s, dtype=torch.int64, device=scn.device)
        t_dev, t_srv, t_up, t_dn, _, _ = delay_terms(scn, prof, s_vec, alloc)
        rows.append(t_dev + t_srv + t_up + t_dn)
    return torch.stack(rows)


def _fastest_split(scn, prof, alloc):
    """Each user's latency-minimal split, the lower index on a tie."""
    t = _latency_table(scn, prof, alloc).cpu().numpy()
    return _split_vec(np.argmin(t, axis=0), scn)


def device_only(scn, prof, q, w=Weights()):
    alloc = default_alloc(scn)
    s = torch.full((scn.cfg.n_users,), prof.n_layers, dtype=torch.int64,
                   device=scn.device)
    return _finish(scn, prof, "device_only", s, alloc, q, w)


def edge_only(scn, prof, q, w=Weights()):
    alloc = default_alloc(scn)
    s = torch.zeros((scn.cfg.n_users,), dtype=torch.int64, device=scn.device)
    return _finish(scn, prof, "edge_only", s, alloc, q, w)


def neurosurgeon(scn, prof, q, w=Weights()):
    alloc = default_alloc(scn)
    s = _fastest_split(scn, prof, alloc)
    return _finish(scn, prof, "neurosurgeon", s, alloc, q, w)


def dnn_surgery(scn, prof, q, w=Weights(), *, lr=0.05, max_steps=200,
                step_impl="fused"):
    """Latency-only: alternate (split pick | GD on p,P,r)."""
    alloc = default_alloc(scn)
    w_lat = Weights(w_t=1.0, w_q=0.0, w_r=0.0, t_scale=w.t_scale)
    q = torch.as_tensor(q, dtype=torch.float32, device=scn.device)
    s = _fastest_split(scn, prof, alloc)
    iters = 0
    for _ in range(2):
        res = ligd._gd_solve(scn, s, q, alloc, lr, 1e-5, max_steps, w_lat,
                             prof, step_impl=step_impl)
        iters += int(res.iters)
        alloc = round_beta(scn, res.alloc)
        s = _fastest_split(scn, prof, alloc)
    return _finish(scn, prof, "dnn_surgery", s, alloc, q, w)._replace(
        iters=iters)


def iao(scn, prof, q, w=Weights(), *, lr=0.05, max_steps=300,
        step_impl="fused"):
    """Joint partition + allocation on latency+energy (ω_Q = 0)."""
    w_iao = Weights(w_t=0.5, w_q=0.0, w_r=0.5,
                    t_scale=w.t_scale, e_scale=w.e_scale,
                    r_cost_scale=w.r_cost_scale)
    spec = ligd.SolverSpec(lr=lr, max_steps=max_steps, step_impl=step_impl)
    out = ligd.solve(scn, prof, q, w_iao, spec=spec)
    q = torch.as_tensor(q, dtype=torch.float32, device=scn.device)
    terms = utility(scn, prof, _split_vec(out.s, scn), out.alloc, q, w)
    return BaselineOutcome("iao", out.s, out.alloc, terms, out.total_iters)


def dina(scn, prof, q, w=Weights()):
    """Min-transfer heuristic: split at the global minimum of crossing
    bytes (never device-only; the lower split on a tie), compute share
    proportional to offloaded FLOPs."""
    cfg = scn.cfg
    alloc = default_alloc(scn)
    u = cfg.n_users
    s_star = int(np.argmin(prof.uplink_bits[:-1].cpu().numpy()))
    s = torch.full((u,), s_star, dtype=torch.int64, device=scn.device)
    edge_share = prof.edge_flops[s]
    r = cfg.r_min + (cfg.r_max - cfg.r_min) * edge_share / torch.clamp(
        torch.max(edge_share), min=1.0)
    alloc = alloc._replace(r=r)
    return _finish(scn, prof, "dina", s, alloc, q, w)


ALL_BASELINES = {
    "device_only": device_only,
    "edge_only": edge_only,
    "neurosurgeon": neurosurgeon,
    "dnn_surgery": dnn_surgery,
    "iao": iao,
    "dina": dina,
}


def run_all(scn, prof, q, w=Weights()):
    return {name: fn(scn, prof, q, w) for name, fn in ALL_BASELINES.items()}
