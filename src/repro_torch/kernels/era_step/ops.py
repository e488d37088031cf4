"""Scenario-level wrapper for the fused ERA GD step: assemble channel-major
operands + static SIC aux from a ``Scenario``, run the step (the CUDA
kernel for CUDA tensors, the plain version for CPU ones), and map the
results back onto ``Allocation`` layouts.

``era_step_value_and_grad`` stands in for autograd of
``era.utility(...).gamma``; ``ligd._gd_core(step_impl='fused')`` uses it.
Everything takes one cell or a batch with a leading cell axis B; the
kernel always sees B (a single cell is a batch of one).

``build_aux`` precomputes what does not depend on the allocation — each
user's SIC decode rank and group id, the AP one-hot, the transposed gains
— once per scenario (``_sweep_core`` hoists it out of the layer loop).
Rank and gid come from ``scatter_`` over the Scenario's sorted orders, not
the JAX package's one-hot einsum (1.56 GB per cell at paper scale); they
are small integers either way, stored as int32.  ``gid`` is the first
decode rank of the user's group, so each group occupies consecutive ranks
— the layout the kernel's in-group loops rely on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.era import Allocation
from repro_torch.core.profiles import take_split
from repro_torch.kernels.era_step.kernel import era_step_fused


class StepAux(NamedTuple):
    """Allocation-independent operands of the fused step.  The own-AP
    gains are not among them: they are the entries of ``h_up_r`` /
    ``h_dn_r`` at each user's serving AP."""
    h_up_r: torch.Tensor       # (N, M, U) uplink gain to AP n, transposed
    h_dn_r: torch.Tensor       # (N, M, U) downlink gain from AP n
    onehot: torch.Tensor       # (N, U) AP-association one-hot
    up_rank: torch.Tensor      # (M, U) int32 SIC decode rank per user
    up_gid: torch.Tensor       # (M, U) int32 SIC group id per user
    dn_rank: torch.Tensor
    dn_gid: torch.Tensor


def _group_starts(group_end):
    """Per sorted position, the first index of its SIC group: position k
    starts a group iff k == 0 or the previous group ended at k-1; a
    running max of start indices labels every member."""
    u = group_end.shape[-1]
    idx = torch.arange(u, dtype=group_end.dtype, device=group_end.device)
    prev_end = torch.cat(
        [torch.full(group_end.shape[:-1] + (1,), -1, dtype=group_end.dtype,
                    device=group_end.device), group_end[..., :-1]], dim=-1)
    is_start = prev_end == (idx - 1)
    starts = torch.where(is_start, idx, torch.zeros_like(idx))
    return torch.cummax(starts, dim=-1).values


def _rank_gid(order, group_end):
    """User-order decode rank + group id from the sorted-order tensors:
    ``rank[m, order[m, k]] = k`` and ``gid[m, order[m, k]] = start(k)``."""
    u = order.shape[-1]
    pos = torch.arange(u, dtype=torch.int64, device=order.device)
    pos = pos.expand(order.shape)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    gid = torch.empty_like(order).scatter_(-1, order,
                                           _group_starts(group_end))
    return rank.to(torch.int32), gid.to(torch.int32)


def build_aux(scn) -> StepAux:
    """Static (per-scenario) operand pack for the fused step."""
    onehot = F.one_hot(scn.assoc, scn.cfg.n_aps).to(torch.float32)
    up_rank, up_gid = _rank_gid(scn.up_order, scn.up_group_end)
    dn_rank, dn_gid = _rank_gid(scn.dn_order, scn.dn_group_end)
    return StepAux(
        h_up_r=scn.h_up.movedim(-3, -1).contiguous(),   # (U,N,M)->(N,M,U)
        h_dn_r=scn.h_dn.transpose(-1, -2).contiguous(), # (N,U,M)->(N,M,U)
        onehot=onehot.transpose(-1, -2).contiguous(),
        up_rank=up_rank, up_gid=up_gid, dn_rank=dn_rank, dn_gid=dn_gid,
    )


def env_row(env, w):
    """The (..., 1, ENV_LANES) env row: ``CellEnv`` scalars in lanes 0-6,
    the ``Weights`` fields in lanes 7-13."""
    lead = tuple(env.noise_w.shape)
    dev = env.noise_w.device
    const = lambda v: torch.full(lead, float(v), dtype=torch.float32,
                                 device=dev)
    zero = const(0.0)
    lanes = [env.noise_w, env.subchannel_bw, env.c_device_flops,
             env.c_min_flops, env.lambda_exponent, env.xi_device,
             env.xi_edge, const(w.w_t), const(w.w_q), const(w.w_r),
             const(w.qoe_a), const(w.t_scale), const(w.e_scale),
             const(w.r_cost_scale), zero, zero]
    return torch.stack([x.to(torch.float32) for x in lanes], dim=-1)[..., None, :]


def layer_operands(scn, prof, s_vec, q, w):
    """The allocation-independent per-layer operands (q, dev_fl, edge_fl,
    wup, wdn as (..., 1, U) rows, and the env row) — built once per GD
    solve, not per step."""
    row = lambda x: x.to(torch.float32)[..., None, :].contiguous()
    return (row(q), row(take_split(prof.device_flops, s_vec)),
            row(take_split(prof.edge_flops, s_vec)),
            row(take_split(prof.uplink_bits, s_vec)),
            row(take_split(prof.downlink_bits, s_vec)),
            env_row(scn.env, w).contiguous())


def _operands(scn, prof, s_vec, q, alloc, aux, w, consts=None):
    """The 18 positional operands of ``ref.fused_step_math``, in order."""
    if consts is None:
        consts = layer_operands(scn, prof, s_vec, q, w)
    q_row, dev_fl, edge_fl, wup, wdn, envp = consts
    row = lambda x: x.to(torch.float32)[..., None, :].contiguous()
    chan = lambda x: x.to(torch.float32).transpose(-1, -2).contiguous()
    return (
        chan(alloc.beta_up), chan(alloc.beta_dn),
        row(alloc.p), row(alloc.p_ap), row(alloc.r), q_row,
        dev_fl, edge_fl, wup, wdn, envp,
        aux.h_up_r, aux.h_dn_r, aux.onehot,
        aux.up_rank, aux.up_gid, aux.dn_rank, aux.dn_gid,
    )


def era_step_value_and_grad(scn, prof, s_vec, q, alloc, w, *, aux=None,
                            consts=None):
    """Fused ``(Γ, ∂Γ/∂Allocation)`` for one GD step.  Pass a precomputed
    ``aux`` (``build_aux``) and ``consts`` (``layer_operands``) when
    calling repeatedly on one scenario and split vector."""
    if aux is None:
        aux = build_aux(scn)
    operands = _operands(scn, prof, s_vec, q, alloc, aux, w, consts)
    single = operands[0].dim() == 2
    if single:
        operands = tuple(x[None] for x in operands)
    gamma, d_bu, d_bd, d_p, d_pap, d_r = era_step_fused(*operands)
    grad = Allocation(beta_up=d_bu.transpose(-1, -2),
                      beta_dn=d_bd.transpose(-1, -2),
                      p=d_p[..., 0, :], p_ap=d_pap[..., 0, :],
                      r=d_r[..., 0, :])
    if single:
        return gamma[0], Allocation(*(x[0] for x in grad))
    return gamma, grad
