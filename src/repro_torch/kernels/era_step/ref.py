"""Plain PyTorch version of the fused ERA GD step — analytic forward +
backward, written as the same channel-block helpers as the JAX oracle
(``repro/kernels/era_step/ref.py``).

One call evaluates the whole per-step body of ``ligd._gd_core``: NOMA
uplink/downlink SIC rates, delay/energy/QoE terms, Γ, and its gradient
w.r.t. every ``Allocation`` leaf — what ``torch.autograd`` of
``era.utility(...).gamma`` gives, without the graph.

Layout: channel-major (..., M, U) for β/gain/ordering tensors, (..., 1, U)
rows for per-user scalars, (..., N, M, U) for the cross-cell gains,
(..., 1, ENV_LANES) for the packed ``CellEnv`` scalars AND the ``Weights``
fields.  The optional leading axis is the cell axis B: every helper
reduces over the user or channel axis only.

Gradient conventions that must match autodiff:
  * ``max(x, 0)`` propagates 0.5 to each side at an exact tie — the
    masked suffix sum is exactly 0.0 for the last-decoded user of every
    SIC group, so ``_tie`` fires on every call;
  * ``sigmoid'(x) = s(1-s)``, ``log2'(x) = 1/((1+x)·ln 2)``,
    ``(r^a)' = a·r^(a-1)``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.noma import relu_tie

_LN2 = 0.6931471805599453

# envp row layout: CellEnv scalars in lanes 0-6, the Weights fields in
# lanes 7-13, lanes 14-15 reserved (the JAX package's 16-lane row).
ENV_LANES = 16
(_NOISE, _BW, _C_DEV, _C_MIN, _LAM_EXP, _XI_D, _XI_E,
 _W_T, _W_Q, _W_R, _QOE_A, _T_SCALE, _E_SCALE, _R_COST) = range(14)


def _lane(envp, k):
    """Lane ``k`` of the (..., 1, ENV_LANES) env row as a (..., 1, 1)
    column that broadcasts against (..., M, U) and (..., 1, U)."""
    return envp[..., k:k + 1]


def _tie(x):
    """d/dx max(x, 0) with JAX's balanced tie rule (0.5 at x == 0)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, 0.0, 0.5)).to(x.dtype)


def _sic_mask(rank, gid):
    """(..., M, U, U) decode-order mask: ``mask[m, i, j] = 1`` iff users i
    and j share channel m's SIC group and j is decoded after i."""
    same = gid[..., :, :, None] == gid[..., :, None, :]
    later = rank[..., :, None, :] > rank[..., :, :, None]
    return (same & later).to(torch.float32)


def _suffix_apply(mask, x):
    """``out[m, i] = Σ_j mask[m, i, j] · x[m, j]``."""
    return torch.einsum("...mij,...mj->...mi", mask, x)


def _suffix_transpose(mask, d):
    """Adjoint of ``_suffix_apply``: ``out[m, j] = Σ_i mask[m, i, j]·d[m, i]``."""
    return torch.einsum("...mij,...mi->...mj", mask, d)


def own_gain_t(h_r, onehot):
    """(..., M, U) gain of each user to its serving AP: the entry of the
    (..., N, M, U) slab at that AP.  Exact — every other AP adds 0·h."""
    return torch.sum(h_r * onehot[..., :, None, :], dim=-3)


def _ap(x, n):
    """Row ``n`` of an (..., N, U) one-hot as an (..., 1, U) row."""
    return x[..., n:n + 1, :]


class _UpFwd(NamedTuple):
    intra_u: torch.Tensor      # (M, U) masked in-group interference
    raw_up: tuple              # per-AP (M, 1) raw inter-cell residual
    d_up: torch.Tensor         # (M, U) SINR denominator
    sinr_up: torch.Tensor
    rate_up: torch.Tensor


class _DnFwd(NamedTuple):
    intra_d: torch.Tensor
    raw_dn: torch.Tensor       # (M, U) other-AP power residual
    d_dn: torch.Tensor
    sinr_dn: torch.Tensor
    rate_dn: torch.Tensor


def _up_forward(beta_up_t, p, own_up_t, h_up_r, onehot, up_rank, up_gid,
                noise, bw):
    """One channel block's uplink SIC pipeline (noma.uplink_sinr)."""
    n_aps = onehot.shape[-2]
    up_mask = _sic_mask(up_rank, up_gid)
    bp_u = beta_up_t * p                          # (M, U) β·p
    contrib_u = bp_u * own_up_t                   # β·p·|h|²
    sig_u = p * own_up_t
    intra_u = _suffix_apply(up_mask, contrib_u)
    # inter-cell residual at AP n summed over OTHER-cell users only
    raw_up = []
    inter_u = torch.zeros_like(bp_u)
    for n in range(n_aps):
        oh = _ap(onehot, n)
        other = bp_u * h_up_r[..., n, :, :] * (1.0 - oh)
        raw = torch.sum(other, dim=-1, keepdim=True)            # (M, 1)
        raw_up.append(raw)
        inter_u = inter_u + relu_tie(raw) * oh
    d_up = relu_tie(intra_u) + inter_u + noise
    sinr_up = sig_u / d_up
    rate_up = bw * torch.log2(1.0 + sinr_up)
    return _UpFwd(intra_u, tuple(raw_up), d_up, sinr_up, rate_up)


def _dn_forward(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot, dn_rank, dn_gid,
                noise, bw):
    """One channel block's downlink SIC pipeline (noma.downlink_sinr)."""
    n_aps = onehot.shape[-2]
    dn_mask = _sic_mask(dn_rank, dn_gid)
    comp_u = beta_dn_t * p_ap
    sig_d = p_ap * own_dn_t
    intra_pwr_u = _suffix_apply(dn_mask, comp_u)
    intra_d = intra_pwr_u * own_dn_t
    raw_dn = torch.zeros_like(comp_u)
    for n in range(n_aps):
        oh = _ap(onehot, n)
        ap_n = torch.sum(comp_u * oh, dim=-1, keepdim=True)     # (M, 1)
        raw_dn = raw_dn + ap_n * h_dn_r[..., n, :, :] * (1.0 - oh)
    inter_d = relu_tie(raw_dn)
    d_dn = relu_tie(intra_d) + inter_d + noise
    sinr_dn = sig_d / d_dn
    rate_dn = bw * torch.log2(1.0 + sinr_dn)
    return _DnFwd(intra_d, raw_dn, d_dn, sinr_dn, rate_dn)


def up_rate_rows(beta_up_t, p, own_up_t, h_up_r, onehot, up_rank, up_gid,
                 noise, bw):
    """Pass 1, uplink: the (1, U) per-user rate row Σ_m β·rate."""
    fwd = _up_forward(beta_up_t, p, own_up_t, h_up_r, onehot,
                      up_rank, up_gid, noise, bw)
    return torch.sum(beta_up_t * fwd.rate_up, dim=-2, keepdim=True)


def dn_rate_rows(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot, dn_rank, dn_gid,
                 noise, bw):
    """Pass 1, downlink rate row."""
    fwd = _dn_forward(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot,
                      dn_rank, dn_gid, noise, bw)
    return torch.sum(beta_dn_t * fwd.rate_dn, dim=-2, keepdim=True)


def tail_grads(r_up, r_dn, p, p_ap, r, q, dev_fl, edge_fl, wup, wdn, envp):
    """The M-free tail: delay / energy / QoE / Γ forward, plus the backward
    chain down to per-user cotangents.  Returns
    ``(gamma, g_rup, g_rdn, d_p0, d_pap0, d_r)``; Γ is (...,) per cell."""
    c_dev = _lane(envp, _C_DEV)
    c_min = _lane(envp, _C_MIN)
    lam_exp = _lane(envp, _LAM_EXP)
    xi_d = _lane(envp, _XI_D)
    xi_e = _lane(envp, _XI_E)
    w_t = _lane(envp, _W_T)
    w_q = _lane(envp, _W_Q)
    w_r = _lane(envp, _W_R)
    qoe_a = _lane(envp, _QOE_A)
    t_scale = _lane(envp, _T_SCALE)
    e_scale = _lane(envp, _E_SCALE)
    r_cost_scale = _lane(envp, _R_COST)
    one = torch.ones((), dtype=r_up.dtype, device=r_up.device)

    lam = r ** lam_exp
    lam_p = lam_exp * r ** (lam_exp - 1.0)
    edge_c = lam * c_min
    t_dev = dev_fl / c_dev
    t_srv = edge_fl / edge_c
    mup = torch.maximum(r_up, one)
    mdn = torch.maximum(r_dn, one)
    t = t_dev + t_srv + wup / mup + wdn / mdn
    e = (xi_d * c_dev ** 2 * dev_fl
         + xi_e * edge_c ** 2 * edge_fl
         + p * wup / mup + p_ap * wdn / mdn)
    rq = torch.sigmoid(qoe_a * (t / q - 1.0))
    cell_sum = lambda x: torch.sum(x, dim=(-2, -1))
    gamma = (w_t[..., 0, 0] * cell_sum(t) * t_scale[..., 0, 0]
             + w_q[..., 0, 0] * (cell_sum((t - q) * rq) * t_scale[..., 0, 0]
                                 + cell_sum(rq))
             + w_r[..., 0, 0] * (cell_sum(e) * e_scale[..., 0, 0]
                                 + cell_sum(lam) * r_cost_scale[..., 0, 0]))

    # backward: Γ -> per-user t/e/r cotangents
    rp = qoe_a * rq * (1.0 - rq) / q              # dR/dt
    g_t = (w_t * t_scale
           + w_q * (t_scale * (rq + (t - q) * rp) + rp))         # (1, U)
    g_e = w_r * e_scale
    d_r = (g_t * (-edge_fl * c_min * lam_p / (edge_c ** 2))
           + g_e * (2.0 * xi_e * c_min ** 2 * lam * lam_p * edge_fl)
           + w_r * r_cost_scale * lam_p)
    g_rup = -_tie(r_up - 1.0) * (wup / mup ** 2) * (g_t + g_e * p)
    g_rdn = -_tie(r_dn - 1.0) * (wdn / mdn ** 2) * (g_t + g_e * p_ap)
    d_p0 = g_e * wup / mup                        # e_up = p·w/max(r,1)
    d_pap0 = g_e * wdn / mdn
    return gamma, g_rup, g_rdn, d_p0, d_pap0, d_r


def up_block_grad(beta_up_t, p, own_up_t, h_up_r, onehot, up_rank, up_gid,
                  noise, bw, g_rup):
    """Pass 2, uplink: the (M, U) β gradient rows and the partial (1, U)
    ``d_p`` row, given the tail's rate-row cotangent.  Recomputes the
    forward."""
    n_aps = onehot.shape[-2]
    up_mask = _sic_mask(up_rank, up_gid)
    fwd = _up_forward(beta_up_t, p, own_up_t, h_up_r, onehot,
                      up_rank, up_gid, noise, bw)
    d_sinr = (g_rup * beta_up_t) * bw / ((1.0 + fwd.sinr_up) * _LN2)
    d_bu = g_rup * fwd.rate_up                    # direct Σ_m β·rate term
    psi = -d_sinr * fwd.sinr_up / fwd.d_up        # cotangent of D
    d_contrib = _suffix_transpose(up_mask, psi * _tie(fwd.intra_u))
    d_bp = torch.zeros_like(beta_up_t)
    for n in range(n_aps):
        oh = _ap(onehot, n)
        g_n = torch.sum(psi * oh, dim=-1, keepdim=True) * _tie(fwd.raw_up[n])
        d_bp = d_bp + g_n * h_up_r[..., n, :, :] * (1.0 - oh)
    d_bp = d_bp + d_contrib * own_up_t
    d_bu = d_bu + d_bp * p
    d_p_part = torch.sum(d_bp * beta_up_t + (d_sinr / fwd.d_up) * own_up_t,
                         dim=-2, keepdim=True)
    return d_bu, d_p_part


def dn_block_grad(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot, dn_rank,
                  dn_gid, noise, bw, g_rdn):
    """Pass 2, downlink block gradient + partial ``d_pap`` row."""
    n_aps = onehot.shape[-2]
    dn_mask = _sic_mask(dn_rank, dn_gid)
    fwd = _dn_forward(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot,
                      dn_rank, dn_gid, noise, bw)
    d_sinr_d = (g_rdn * beta_dn_t) * bw / ((1.0 + fwd.sinr_dn) * _LN2)
    d_bd = g_rdn * fwd.rate_dn
    psi_d = -d_sinr_d * fwd.sinr_dn / fwd.d_dn
    d_inter = psi_d * _tie(fwd.raw_dn)
    d_comp = _suffix_transpose(dn_mask,
                               psi_d * _tie(fwd.intra_d) * own_dn_t)
    for n in range(n_aps):
        oh = _ap(onehot, n)
        d_ap_n = torch.sum(d_inter * h_dn_r[..., n, :, :] * (1.0 - oh),
                           dim=-1, keepdim=True)                  # (M, 1)
        d_comp = d_comp + d_ap_n * oh
    d_bd = d_bd + d_comp * p_ap
    d_pap_part = torch.sum(d_comp * beta_dn_t + (d_sinr_d / fwd.d_dn)
                           * own_dn_t, dim=-2, keepdim=True)
    return d_bd, d_pap_part


def fused_step_math(beta_up_t, beta_dn_t, p, p_ap, r, q,
                    dev_fl, edge_fl, wup, wdn, envp,
                    h_up_r, h_dn_r, onehot,
                    up_rank, up_gid, dn_rank, dn_gid):
    """The fused forward+backward — the four helpers composed on the whole
    channel axis.  Returns ``(gamma, (d_beta_up_t, d_beta_dn_t, d_p,
    d_pap, d_r))`` with gradients in the layouts of their operands.  The
    own-AP gains are taken from the cross-gain slabs (``own_gain_t``), as
    the CUDA kernel reads them."""
    own_up_t = own_gain_t(h_up_r, onehot)
    own_dn_t = own_gain_t(h_dn_r, onehot)
    noise = _lane(envp, _NOISE)
    bw = _lane(envp, _BW)
    r_up = up_rate_rows(beta_up_t, p, own_up_t, h_up_r, onehot,
                        up_rank, up_gid, noise, bw)
    r_dn = dn_rate_rows(beta_dn_t, p_ap, own_dn_t, h_dn_r, onehot,
                        dn_rank, dn_gid, noise, bw)
    gamma, g_rup, g_rdn, d_p, d_pap, d_r = tail_grads(
        r_up, r_dn, p, p_ap, r, q, dev_fl, edge_fl, wup, wdn, envp)
    d_bu, d_p_part = up_block_grad(beta_up_t, p, own_up_t, h_up_r, onehot,
                                   up_rank, up_gid, noise, bw, g_rup)
    d_bd, d_pap_part = dn_block_grad(beta_dn_t, p_ap, own_dn_t, h_dn_r,
                                     onehot, dn_rank, dn_gid, noise, bw,
                                     g_rdn)
    return gamma, (d_bu, d_bd, d_p + d_p_part, d_pap + d_pap_part, d_r)
