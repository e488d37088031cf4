"""Mixture-of-Experts FFN: capacity-based scatter dispatch (GShard), or
dropless (``cfg.capacity_factor`` None).

Top-k routing -> exclusive cumsum position-in-expert -> scatter of the kept
(token, slot) rows into a (G, E, C, d) capacity buffer -> batched expert
SwiGLU -> gather / combine.  Compute scales with top_k × tokens ×
capacity_factor, not with E.

``cfg.moe_dispatch_groups`` partitions the tokens into independent dispatch
groups, each with its own capacity (GShard's per-device capacity); it falls
back to one group when it does not divide the token count.  Slots past an
expert's capacity in their group are dropped and contribute zero; the
router's aux loss keeps the load balanced.

The semantics are the JAX package's ``models/moe.py`` exactly, with two
choices made explicit for torch:

  * ties in top-k go to the lower expert index (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none), by a stable descending sort;
  * the scatter writes only the kept rows, with an index write and no
    accumulate: each kept (group, expert, position) is unique, so the
    buffer equals JAX's (whose dropped rows add exact zeros) and is
    bit-identical from run to run on the card.

No hand-written kernel backs this module: the expert FFN is
``torch.einsum`` batched over E on (G, E, C, d) and ``common.activate``.

Dropless (``capacity_factor=None``, how Mixtral is served): the same
routing, then the T·k routes ordered by expert (a stable sort, so each
expert's rows keep their token order), each expert's SwiGLU on its own
rows alone through ``torch._grouped_mm`` (offsets on the device: no host
sync, nothing padded), and the rows put back in token-major slot order
and summed with their gates in that fixed order.  No route is dropped,
so a token's output does not depend on the other tokens of its batch.
It runs on plain tensors only: training and the sharded path keep the
capacity dispatch.

A configuration with a shared expert (``shared_d_ff``: Granite 4.0-H)
adds that SwiGLU, run on every token as a dense FFN, to the routed sum.

Each call is a ``moe`` span (``telemetry.spans``) with ``tokens``,
``routed_rows`` (T·k), ``shared_rows`` (the rows the shared expert
runs: T, or 0 without one), ``experts_hit``, ``max_expert_rows`` and
``dropped_rows``; the last three stay device tensors until the spans are
read, so a traced call adds no host sync.  ``DROPPED_ROUTES`` counts,
on the device, the routes the capacity path drops (the dropless path
adds nothing); its ``read()`` syncs.

``constrain`` is the distributed layer's sharding hook, called under
JAX's names (``moe_groups``, ``moe_buf``, ``moe_buf_expert``).  On
DTensors the routing, scatter and gather run on each rank's own groups
(``_forward_sharded``): the distributed layer sets
``moe_dispatch_groups`` to the data extent, as JAX's dry run does, so
dispatch never leaves a rank, and ``moe_buf -> moe_buf_expert`` is the
expert-parallel all-to-all.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import (Params, activate, dense_init,
                                       dtype_of, no_constrain)
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.ffn import is_gated
from repro_torch.telemetry import spans

# expert-FFN capacity chunk: bounds the (G, E, Cc, d_ff) hidden buffers of
# very long prefills
C_CHUNK = 8192


def init(generator, cfg, device):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    p = {
        "router": dense_init(generator, (d, e), torch.float32, device),
        "w_in": dense_init(generator, (e, d, f), dt, device, in_axis_size=d),
        "w_out": dense_init(generator, (e, f, d), dt, device,
                            in_axis_size=f),
    }
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(generator, (e, d, f), dt, device,
                                 in_axis_size=d)
    if cfg.shared_d_ff:
        p["shared"] = ffn_mod.init(generator, cfg, device,
                                   d_ff=cfg.shared_d_ff)
    return Params(**p)


class RouteCounter:
    """A running count of dropped routes, one int64 tensor on each device
    it was given counts on; nothing is read until ``read``."""

    def __init__(self):
        self._by_device = {}

    def add(self, n):
        """Add the count ``n`` (a 0-d integer tensor) on its device."""
        t = self._by_device.get(n.device)
        if t is None:
            self._by_device[n.device] = n.to(torch.int64).clone()
        else:
            t.add_(n)

    def read(self) -> int:
        """The count over every device (one sync each)."""
        return sum(int(t) for t in self._by_device.values())

    def reset(self):
        self._by_device.clear()


# routes dropped past an expert's capacity in this process
DROPPED_ROUTES = RouteCounter()


def dropless(cfg) -> bool:
    """True where every route is computed: ``capacity_factor`` None."""
    return cfg.capacity_factor is None


def capacity(cfg, n_tokens: int) -> int:
    """Per-group expert capacity for a group of ``n_tokens`` tokens."""
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    c = max(c, cfg.top_k)
    if c > C_CHUNK:  # round up so the chunked expert loop divides evenly
        c = (c + C_CHUNK - 1) // C_CHUNK * C_CHUNK
    return c


def _route(router, cfg, x_flat):
    """(expert_idx, gates, me, ce): ``me`` the share of tokens whose first
    choice is each expert and ``ce`` the mean router probability, each
    over every leading axis of ``x_flat``."""
    logits = torch.matmul(x_flat.float(), router)
    probs = torch.softmax(logits, dim=-1)
    # stable: equal probabilities keep their index order, as lax.top_k
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :cfg.top_k], order[..., :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    lead = tuple(range(idx.ndim - 1))
    me = torch.mean(torch.nn.functional.one_hot(idx[..., 0], cfg.n_experts)
                    .float(), dim=lead)
    ce = torch.mean(probs, dim=lead)
    return idx, gate, me, ce


def route(params, cfg, x_flat):
    """x_flat (..., T, d) -> (expert_idx (..., T, k) int64, gates (..., T, k)
    float32, aux).  The router runs in float32."""
    idx, gate, me, ce = _route(params.router, cfg, x_flat)
    return idx, gate, cfg.n_experts * torch.sum(me * ce)


def groups(cfg, n_tokens: int) -> int:
    """The dispatch group count for ``n_tokens`` tokens."""
    g = cfg.moe_dispatch_groups
    return max(g if n_tokens % max(g, 1) == 0 else 1, 1)


def slots(cfg, idx, cap):
    """Each (token, slot)'s place in its expert, token-major (token t's k
    slots adjacent): (flat_e (G, T·k), pos (G, T·k), keep (G, T·k)).
    ``pos`` is the exclusive cumsum over that order; ``keep = pos < cap``."""
    g = idx.shape[0]
    flat_e = idx.reshape(g, -1)
    # the running count of each expert along the slots, scanned along the
    # innermost axis of an (G, E, T·k) layout (a scan across the E columns
    # of (G, T·k, E) runs one thread per column on the card)
    onehot = torch.nn.functional.one_hot(flat_e, cfg.n_experts)
    count = torch.cumsum(onehot.transpose(1, 2).contiguous(), dim=2)
    pos = torch.gather(count, 1, flat_e[:, None, :])[:, 0] - 1
    return flat_e, pos, pos < cap


def _per_expert(block, w):
    """(G, E, C, a) x (E, a, b) -> (G, E, C, b), as JAX's einsum: batched
    over E with (G, C) flattened (a broadcasting matmul would expand the
    expert weights over the G groups, and DTensor would gather and copy
    them G times)."""
    return torch.einsum("gecd,edf->gecf", block, w)


def _expert_ffn(params, cfg, block, constrain=no_constrain):
    """(G, E, C, d) -> (G, E, C, d), every expert on its own rows."""
    h_lin = constrain(_per_expert(block, params.w_in), "moe_buf_expert")
    if is_gated(cfg.activation):
        h_gate = constrain(_per_expert(block, params.w_gate),
                           "moe_buf_expert")
        h = activate(h_gate, h_lin, cfg.activation)
        del h_gate
    else:
        h = activate(h_lin, h_lin, cfg.activation)
    del h_lin
    return constrain(_per_expert(h, params.w_out), "moe_buf_expert")


def _dispatch(router, cfg, xg, cap):
    """Route the (G, Tl, d) groups and scatter each kept slot's token row
    into a (G, E, C, d) capacity buffer, written once.  Returns (buf,
    (flat_e, pos, keep, gate), me, ce)."""
    g, tl, d = xg.shape
    idx, gate, me, ce = _route(router, cfg, xg)          # (G, Tl, k)
    flat_e, pos, keep = slots(cfg, idx, cap)             # (G, Tl·k)
    if keep.is_meta:
        # the dry run's abstract shapes have no keep bits to count: every
        # slot is taken, the T·k rows JAX's scatter processes
        tk = keep.shape[1]
        kg = torch.arange(g, device=keep.device).repeat_interleave(tk)
        ks = torch.arange(tk, device=keep.device).repeat(g)
    else:
        kg, ks = torch.nonzero(keep, as_tuple=True)
        DROPPED_ROUTES.add(torch.sum(~keep))
    buf = torch.zeros((g, cfg.n_experts, cap, d), dtype=xg.dtype,
                      device=xg.device)
    buf[kg, flat_e[kg, ks], pos[kg, ks]] = xg[kg, ks // cfg.top_k]
    return buf, (flat_e, pos, keep, gate), me, ce


def _experts(params, cfg, buf, cap, constrain):
    """The expert FFN on the capacity buffer, ``C_CHUNK`` rows an expert
    at a time for huge capacities; the dispatch and combine all-to-alls
    are the ``moe_buf`` <-> ``moe_buf_expert`` constraints."""
    # dispatch all-to-all: reshard to the compute layout (E -> model when
    # expert-parallel); explicit, so the scatter stays shard-local
    buf = constrain(constrain(buf, "moe_buf"), "moe_buf_expert")
    chunked = cap > C_CHUNK and cap % C_CHUNK == 0
    if isinstance(buf, DTensor):
        # the chunks are joined by a cat: a slice write into a sharded
        # buffer has no DTensor rule
        parts = [_expert_ffn(params, cfg, buf[:, :, c0:c0 + C_CHUNK],
                             constrain) for c0 in range(0, cap, C_CHUNK)] \
            if chunked else [_expert_ffn(params, cfg, buf, constrain)]
        out_buf = torch.cat(parts, dim=2) if chunked else parts[0]
    elif chunked:
        out_buf = torch.empty_like(buf)
        for c0 in range(0, cap, C_CHUNK):
            out_buf[:, :, c0:c0 + C_CHUNK] = _expert_ffn(
                params, cfg, buf[:, :, c0:c0 + C_CHUNK])
    else:
        out_buf = _expert_ffn(params, cfg, buf)           # (G, E, C, d)
    # combine all-to-all: back to the dispatch layout
    return constrain(out_buf, "moe_buf")


def _combine(cfg, out_buf, info, cap):
    """Each slot's expert row times its gate, summed over the token's k
    slots; dropped slots add 0.  (G, Tl, d)."""
    flat_e, pos, keep, gate = info
    g, tk = flat_e.shape
    safe_pos = torch.where(keep, pos, cap - 1)
    gi = torch.arange(g, device=flat_e.device)[:, None]
    gathered = out_buf[gi, flat_e, safe_pos]              # (G, Tl·k, d)
    w = torch.where(keep, gate.reshape(g, tk).to(out_buf.dtype),
                    torch.zeros((), dtype=out_buf.dtype,
                                device=out_buf.device))
    k = cfg.top_k
    return (gathered * w[..., None]).reshape(g, tk // k, k, -1).sum(dim=2)


def forward(params, cfg, x, constrain=no_constrain):
    """x (B, S, d) -> (y, aux_loss); the ``moe`` span (module docs).  A
    configuration with a shared expert (``shared_d_ff``) adds its SwiGLU
    on every token to the routed experts' sum."""
    b, s, d = x.shape
    shared = b * s if cfg.shared_d_ff else 0
    with spans.span("moe", tokens=b * s, routed_rows=b * s * cfg.top_k,
                    shared_rows=shared) as sp:
        y, aux = _routed(params, cfg, x, constrain, sp)
        if shared:
            y = y + ffn_mod.forward(params.shared, cfg, x)
        return y, aux


def _routed(params, cfg, x, constrain, sp):
    """The routed experts' part of ``forward``, inside its span ``sp``."""
    b, s, d = x.shape
    if dropless(cfg):
        if isinstance(x, DTensor):
            raise ValueError("the dropless MoE runs on plain tensors; "
                             "a mesh takes the capacity dispatch "
                             "(capacity_factor set)")
        y, aux = _forward_dropless(params, cfg, x.reshape(b * s, d), sp)
        return y.reshape(b, s, d), aux
    g = groups(cfg, b * s)
    tl = b * s // g
    cap = capacity(cfg, tl)
    xg = constrain(x.reshape(g, tl, d), "moe_groups")
    if isinstance(xg, DTensor):
        y, aux = _forward_sharded(params, cfg, xg, cap, constrain, b)
        return y.reshape(b, s, d), aux
    buf, info, me, ce = _dispatch(params.router, cfg, xg, cap)
    if sp and not xg.is_meta:
        flat_e, _, keep, _ = info
        rows = torch.zeros(cfg.n_experts, dtype=torch.int64,
                           device=keep.device)
        rows.scatter_add_(0, flat_e.reshape(-1),
                          keep.reshape(-1).to(torch.int64))
        _count(sp, rows, torch.sum(~keep))
    out_buf = _experts(params, cfg, buf, cap, constrain)
    del buf
    y = _combine(cfg, out_buf, info, cap)
    return y.reshape(b, s, d), cfg.n_experts * torch.sum(me * ce)


def _count(sp, rows, dropped=0):
    """The span's device-side counts from the rows each expert computes:
    experts with a row, the most rows an expert computes, the routes
    dropped."""
    sp.set(experts_hit=torch.count_nonzero(rows), max_expert_rows=rows.max(),
           dropped_rows=dropped)


def _forward_dropless(params, cfg, x, sp):
    """x (T, d) -> (y (T, d), aux): every route computed (module docs)."""
    t, d = x.shape
    k = cfg.top_k
    idx, gate, me, ce = _route(params.router, cfg, x)      # (T, k)
    experts, order = torch.sort(idx.reshape(-1), stable=True)
    # where each expert's rows end (``bincount`` would read its input's
    # largest value to the host)
    ends = torch.searchsorted(experts, torch.arange(
        cfg.n_experts, device=x.device), right=True, out_int32=True)
    if sp:
        _count(sp, torch.diff(ends, prepend=ends.new_zeros(1)))
    out = _grouped_ffn(params, cfg, x[order // k], ends)
    slots = torch.empty_like(out).index_copy_(0, order, out)
    y = (slots.view(t, k, d) * gate.to(x.dtype)[..., None]).sum(dim=1)
    return y, cfg.n_experts * torch.sum(me * ce)


def _grouped_ffn(params, cfg, rows, ends):
    """Each expert's FFN on its own rows: ``rows`` (R, d) sorted by
    expert, expert e's rows ending at ``ends[e]`` (int32, on the device).
    Returns (R, d)."""
    mm = lambda a, w: torch._grouped_mm(a, w, offs=ends)
    h_lin = mm(rows, params.w_in)
    if is_gated(cfg.activation):
        h = activate(mm(rows, params.w_gate), h_lin, cfg.activation)
    else:
        h = activate(h_lin, h_lin, cfg.activation)
    del h_lin
    return mm(h, params.w_out)


def _forward_sharded(params, cfg, xg, cap, constrain, batch):
    """``forward`` on DTensors: routing, the scatter and the gather run on
    each rank's own groups (``torch.nonzero`` has no DTensor rule, and a
    group's slots never leave it), with the groups on the mesh axes the
    ``moe_groups`` layout gives them and everything else whole; the
    expert FFN runs on the mesh.  The balance loss averages ``me`` and
    ``ce`` over every group before their product, as on one device."""
    mesh = xg.device_mesh
    grp = tuple(Shard(0) if p == Shard(0) else Replicate()
                for p in xg.placements)
    # a rank's groups contribute its share of the router's gradient
    shared = tuple(Partial() if p == Shard(0) else Replicate() for p in grp)
    router = params.router.redistribute(
        mesh, (Replicate(),) * mesh.ndim).to_local(grad_placements=shared)
    buf, info, me, ce = _dispatch(
        router, cfg, xg.redistribute(mesh, grp).to_local(), cap)
    # each rank's means stacked along the group axes, averaged over them
    me, ce = (DTensor.from_local(v[None], mesh, grp).mean(0)
              for v in (me, ce))
    aux = cfg.n_experts * torch.sum(me * ce)
    out_buf = _experts(params, cfg, DTensor.from_local(buf, mesh, grp), cap,
                       constrain)
    del buf
    y = _combine(cfg, out_buf.redistribute(mesh, grp).to_local(), info, cap)
    y = DTensor.from_local(y, mesh, grp)
    if batch % math.prod(mesh.size(i) for i, p in enumerate(grp)
                         if p == Shard(0)):
        # a group is a part of a row: the rows cannot keep the groups'
        # layout, so they are gathered whole
        y = y.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return y, aux
