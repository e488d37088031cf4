"""NOMA uplink/downlink SINR and achievable rates (paper eqs. 5–11).

SIC semantics:
  uplink (eq. 5): the AP decodes stronger users first, so user i sees
    intra-cell interference from same-cell users with LOWER gain on the same
    subchannel, plus inter-cell interference from every user on that channel
    in other cells.
  downlink (eq. 8): weaker users decode first, so user i sees interference
    from the power components of same-cell users with HIGHER gain, plus other
    APs' total transmit power on the channel.

Rates are Σ_m β_im · (B/M)·log2(1+SINR_im) over the relaxed β ∈ [0,1]^{U×M}.

The in-group suffix is a masked matvec, never a cumsum difference: the
mask sums only in-group terms, so an empty suffix is EXACTLY 0.0 and the
balanced relu tie (gradient 0.5 at 0) fires deterministically.  Every
``max(·, 0)`` here is ``torch.maximum`` against a zero tensor, whose
backward splits the gradient 0.5/0.5 at a tie as JAX's does (``clamp``
and ``relu`` would give 1 or 0).  Inter-cell terms are other-cell masked
sums, never total − own.

Every function takes one cell, or a batch with a leading cell axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.network import env_col


def relu_tie(x):
    """max(x, 0) with JAX's balanced tie gradient."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _suffix_interference(contrib_sorted, group_end):
    """contrib_sorted: (..., M, U) sorted per SIC order.  Returns, per
    position i, the sum of contributions of positions (i, group_end[i]]
    as a masked matvec (exact empty-suffix zeros, no cancellation)."""
    u = contrib_sorted.shape[-1]
    idx = torch.arange(u, device=contrib_sorted.device)
    same = group_end[..., :, None] == group_end[..., None, :]
    later = idx[None, :] > idx[:, None]
    mask = (same & later).to(contrib_sorted.dtype)
    return torch.einsum("...ij,...j->...i", mask, contrib_sorted)


def _sorted_suffix(x, order, group_end):
    """(..., U, M) per-user values -> their in-group decoded-after suffix,
    back in (..., U, M) user order."""
    c_sorted = torch.gather(x.transpose(-1, -2), -1, order)      # (..., M, U)
    intra_sorted = _suffix_interference(c_sorted, group_end)
    return torch.zeros_like(c_sorted).scatter(
        -1, order, intra_sorted).transpose(-1, -2)


def _other_cell(assoc, n_aps, dtype):
    """(..., U, N) mask of the APs that do NOT serve each user."""
    return 1.0 - F.one_hot(assoc, n_aps).to(dtype)


def uplink_sinr(scn, beta_up, p):
    """beta_up (U, M) in [0,1]; p (U,) watts. Returns SINR (U, M)."""
    own = scn.own_gain_up()                                  # (U, M)
    bp = beta_up * p[..., None]
    contrib = bp * own                                       # β·p·|h|²
    intra = _sorted_suffix(contrib, scn.up_order, scn.up_group_end)

    # inter-cell: received at AP n from users of OTHER cells
    other = _other_cell(scn.assoc, scn.cfg.n_aps, contrib.dtype)
    t_other = torch.einsum("...um,...unm,...un->...nm", bp, scn.h_up, other)
    m = t_other.shape[-1]
    inter = torch.gather(relu_tie(t_other), -2,
                         scn.assoc[..., None].expand(*scn.assoc.shape, m))

    sig = p[..., None] * own
    noise = env_col(scn.env.noise_w, sig)
    return sig / (relu_tie(intra) + inter + noise)


def downlink_sinr(scn, beta_dn, p_ap):
    """beta_dn (U, M); p_ap (U,) watts (per-user power component at its
    AP).  Intra-cell components of stronger users reach user i through its
    own channel (sum_q β_q P_q · |H_i|²)."""
    own = scn.own_gain_dn()                                  # (U, M)
    comp = beta_dn * p_ap[..., None]                         # power comps
    intra = _sorted_suffix(comp, scn.dn_order, scn.dn_group_end) * own

    # inter-cell: OTHER APs' total power through the cross gain h_dn[x,i,m]
    onehot = F.one_hot(scn.assoc, scn.cfg.n_aps).to(comp.dtype)   # (U, N)
    ap_power = torch.einsum("...un,...um->...nm", onehot, comp)   # (N, M)
    cross = torch.einsum("...nm,...num,...un->...um", ap_power, scn.h_dn,
                         1.0 - onehot)
    inter = relu_tie(cross)

    sig = p_ap[..., None] * own
    noise = env_col(scn.env.noise_w, sig)
    return sig / (relu_tie(intra) + inter + noise)


def rates(scn, beta, sinr, bandwidth=None):
    """Σ_m β·(B/M)·log2(1+SINR) per user. Returns (U,) bits/s."""
    bw = scn.env.subchannel_bw if bandwidth is None else bandwidth
    per_ch = env_col(bw, sinr) * torch.log2(1.0 + sinr)
    return torch.sum(beta * per_ch, dim=-1)


def uplink_rates(scn, beta_up, p):
    return rates(scn, beta_up, uplink_sinr(scn, beta_up, p))


def downlink_rates(scn, beta_dn, p_ap):
    return rates(scn, beta_dn, downlink_sinr(scn, beta_dn, p_ap))


def sic_feasible(scn, beta_up, p):
    """Uplink SIC decode-threshold constraint p·|h|² > I (paper §II.B) on
    the hard-assigned channel (argmax β)."""
    own = scn.own_gain_up()
    ch = torch.argmax(beta_up, dim=-1)
    gain = torch.gather(own, -1, ch[..., None])[..., 0]
    return p * gain > env_col(scn.env.sic_threshold_w, p)
