"""Scenario-level wrapper: assemble SIC-sorted tensors from a Scenario +
allocation, run the rate kernel, scatter back to user order.  The gather,
the other-cell sum, the scatter and the β-weighted channel sum stay plain
torch around the kernel, as they stay jnp around the TPU kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.network import env_col
from repro_torch.core.noma import relu_tie
from repro_torch.kernels.noma_rate.kernel import noma_rate


def _batched(x):
    return x if x.dim() == 3 else x[None]


def sorted_operands(scn, beta_up, p):
    """The kernel's operands ``(contrib, sig, group_end, inter, bw)``: the
    first four (B, M, U) in SIC decode order, ``bw`` (B,).  One cell or a
    batch; a single cell comes out as a batch of one."""
    own = scn.own_gain_up()                             # (U, M)
    bp = beta_up * p[..., None]
    contrib = (bp * own).transpose(-1, -2)              # (M, U)
    sig = (p[..., None] * own).transpose(-1, -2)

    # inter-cell + noise in user order: a masked other-cell sum, never
    # t_all - own_cell (same formulation as core.noma.uplink_sinr)
    other = 1.0 - F.one_hot(scn.assoc, scn.cfg.n_aps).to(beta_up.dtype)
    t_other = torch.einsum("...um,...unm,...un->...nm", bp, scn.h_up, other)
    m = t_other.shape[-1]
    inter = torch.gather(relu_tie(t_other), -2,
                         scn.assoc[..., None].expand(*scn.assoc.shape, m))
    inter = inter.transpose(-1, -2) + env_col(scn.env.noise_w, contrib)

    order = scn.up_order
    sort = lambda x: _batched(torch.gather(x, -1, order)).contiguous()
    key = _batched(scn.up_group_end.to(torch.int32)).contiguous()
    bw = scn.env.subchannel_bw.to(torch.float32).reshape(-1).contiguous()
    return sort(contrib), sort(sig), key, sort(inter), bw


def uplink_rates_kernel(scn, beta_up, p):
    """Drop-in for ``core.noma.uplink_rates`` on the no-gradient path;
    one cell or a batch with a leading cell axis."""
    rate_sorted = noma_rate(*sorted_operands(scn, beta_up, p))
    # back to user order, then weight by β and sum over channels
    order = _batched(scn.up_order)
    rates = torch.zeros_like(rate_sorted).scatter(-1, order, rate_sorted)
    out = torch.sum(_batched(beta_up.transpose(-1, -2)) * rates, dim=-2)
    return out if beta_up.dim() == 3 else out[0]
