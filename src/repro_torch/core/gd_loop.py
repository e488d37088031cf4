"""Li-GD's GD loop: the pieces its eager and its graphed runs share.

``gd_step`` builds one step of projected, preconditioned GD on Γ over B
lanes; ``advance`` takes it on every active lane and keeps a stopped
lane's carry by select, so each lane's iterates and count are those of an
isolated solve.  ``ligd._gd_core`` runs ``advance`` from the host step by
step (the eager loop); ``sweep_graph.SweepRunner`` captures
``check_every`` of them as a CUDA graph (the compiled sweep).
``SWEEP_STATS`` counts what either did: the host's reads of the "some lane
is still active" flag, graph replays, graph captures and the era_step
launches of the capture warm-ups.  Each count also goes to the innermost
open ``telemetry.spans`` span of the counting thread (a solver layer's,
or the per-user GD's), beside the steps run, the time the host waited on
the flag (``flag_wait_s``) and, graphed, its time in the replay calls
(``replay_s``).
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from repro_torch.core.era import Allocation, clip_alloc, utility
from repro_torch.core.network import env_col, tree_map
from repro_torch.kernels.era_step import ops as era_step_ops
from repro_torch.telemetry import spans

# over every solve since the last reset (``SWEEP_STATS.update(...)``)
SWEEP_STATS = dict(flag_reads=0, replays=0, captures=0, warmup_launches=0)
_STATS_LOCK = threading.Lock()


def tally(**counts):
    """Add ``counts`` to ``SWEEP_STATS`` (shard threads count at once)
    and to this thread's innermost open span."""
    with _STATS_LOCK:
        for name, n in counts.items():
            SWEEP_STATS[name] += n
    spans.add(**counts)


class GDResult(NamedTuple):
    alloc: Allocation
    gamma: torch.Tensor
    iters: torch.Tensor


class Carry(NamedTuple):
    """The GD loop's per-lane state, each with leading axis B."""
    alloc: Allocation
    prev_val: torch.Tensor        # last Γ (the |ΔΓ| stop test's reference)
    k: torch.Tensor               # int64 steps taken
    done: torch.Tensor            # bool: the stop test fired
    cur_lr: torch.Tensor          # step size (moves only when adaptive)


def scales(env):
    """Per-variable preconditioner ranges from the (batched) ``CellEnv``."""
    return Allocation(
        beta_up=1.0,
        beta_dn=1.0,
        p=env.p_max_w - env.p_min_w,
        p_ap=env.ap_p_max_w - env.ap_p_min_w,
        r=env.r_max - env.r_min,
    )


def select(cond, new, old):
    """Per-lane select over an Allocation (or tensor) with leading B."""
    return tree_map(lambda n, o: torch.where(env_col(cond, n), n, o),
                    new, old)


def gd_step(scn, s_vec, q, lr, tol, w, prof, adaptive=False,
            step_impl="fused", step_aux=None, consts=None):
    """``(loss, body)`` of projected, preconditioned GD on Γ over B lanes:
    ``loss(alloc)`` is Γ per lane and ``body(alloc, prev_val, cur_lr)``
    one step of every lane, ``(new, val, done, new_lr)``.

    ``adaptive=True``: backtracking step control — shrink 0.5× on a
    worsening step (and reject it), grow 1.1× on an improving one.
    ``step_impl='fused'`` takes Γ and ∂Γ from the era_step kernel (its
    plain version on the CPU), with ``step_aux`` (``build_aux``) and
    ``consts`` (``layer_operands``) built here when not given; the final
    Γ of a solve and the adaptive path's extra forward stay on
    ``utility``."""

    def loss(alloc):
        return utility(scn, prof, s_vec, alloc, q, w).gamma

    if step_impl == "fused":
        aux = step_aux if step_aux is not None else era_step_ops.build_aux(scn)
        if consts is None:
            consts = era_step_ops.layer_operands(scn, prof, s_vec, q, w)

        def grad_fn(alloc):
            return era_step_ops.era_step_value_and_grad(
                scn, prof, s_vec, q, alloc, w, aux=aux, consts=consts)
    else:
        def grad_fn(alloc):
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True) for x in alloc]
                val = loss(Allocation(*leaves))
                grads = torch.autograd.grad(val.sum(), leaves)
            return val.detach(), Allocation(*grads)

    ranges = scales(scn.env)

    def body(alloc, prev_val, cur_lr):
        val, g = grad_fn(alloc)
        # guard against inf gradients from degenerate (near-zero-rate)
        # allocations: 1/R² terms in eq. (34) blow up as R -> 0
        g = Allocation(*(torch.where(torch.isfinite(x), x,
                                     torch.zeros_like(x)) for x in g))
        sq = 0.0
        for x in g:
            sq = sq + torch.sum(x ** 2, dim=tuple(range(1, x.dim())))
        gnorm = torch.sqrt(sq)
        step = Allocation(*(
            env_col(cur_lr, gg) * env_col(sc, gg) * gg
            / env_col(gnorm + 1e-12, gg)
            for gg, sc in zip(g, ranges)))
        new = clip_alloc(scn, Allocation(*(a - d for a, d in
                                           zip(alloc, step))))
        if adaptive:
            new_val = loss(new)
            improved = new_val < val
            new = select(improved, new, alloc)
            new_val = torch.where(improved, new_val, val)
            cur_lr = torch.where(improved, cur_lr * 1.1, cur_lr * 0.5)
            done = ((torch.abs(new_val - val) < tol * (1.0 + torch.abs(val)))
                    | (gnorm < tol) | (cur_lr < lr * 1e-3))
            return new, new_val, done, cur_lr
        # plain GD: the |ΔΓ| stop compares against the previous iterate's
        # value instead of paying a third Γ evaluation per step
        done = ((torch.abs(val - prev_val) < tol * (1.0 + torch.abs(val)))
                | (gnorm < tol))
        return new, val, done, cur_lr

    return loss, body


def init_carry(loss, x0, lr, adaptive) -> Carry:
    """The carry a GD solve from ``x0`` starts with."""
    n_lanes = x0.p.shape[0]
    dev = x0.p.device
    prev_val = (loss(x0) if adaptive else
                torch.full((n_lanes,), float("inf"), device=dev))
    return Carry(x0, prev_val,
                 torch.zeros((n_lanes,), dtype=torch.int64, device=dev),
                 torch.zeros((n_lanes,), dtype=torch.bool, device=dev),
                 torch.full((n_lanes,), lr, dtype=torch.float32, device=dev))


def active(c: Carry, max_steps):
    """Lanes whose stop test has not fired and whose budget is not spent."""
    return ~c.done & (c.k < max_steps)


def advance(body, c: Carry, max_steps) -> Carry:
    """One step of every active lane; a stopped lane's carry is kept by
    select, so its iterate and count are those of an isolated solve."""
    on = active(c, max_steps)
    new, val, new_done, new_lr = body(c.alloc, c.prev_val, c.cur_lr)
    return Carry(select(on, new, c.alloc),
                 torch.where(on, val, c.prev_val),
                 c.k + on.to(c.k.dtype),
                 torch.where(on, new_done, c.done),
                 torch.where(on, new_lr, c.cur_lr))
