"""Mixture-of-Experts FFN with capacity-based scatter dispatch (GShard).

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

No hand-written kernel backs this module: the expert FFN is batched
``torch.matmul`` over (G, E, C, d) and ``common.activate``.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import Params, activate, dense_init, dtype_of
from repro_torch.models.ffn import is_gated

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
    return Params(**p)


def capacity(cfg, n_tokens: int) -> int:
    """Per-group expert capacity for a group of ``n_tokens`` tokens."""
    c = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    c = max(c, cfg.top_k)
    if c > C_CHUNK:  # round up so the chunked expert loop divides evenly
        c = (c + C_CHUNK - 1) // C_CHUNK * C_CHUNK
    return c


def route(params, cfg, x_flat):
    """x_flat (..., T, d) -> (expert_idx (..., T, k) int64, gates (..., T, k)
    float32, aux).  The router runs in float32."""
    logits = torch.matmul(x_flat.float(), params.router)
    probs = torch.softmax(logits, dim=-1)
    # stable: equal probabilities keep their index order, as lax.top_k
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :cfg.top_k], order[..., :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    lead = tuple(range(idx.ndim - 1))
    me = torch.mean(torch.nn.functional.one_hot(idx[..., 0], e).float(),
                    dim=lead)
    ce = torch.mean(probs, dim=lead)
    aux = e * torch.sum(me * ce)
    return idx, gate, aux


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


def _expert_ffn(params, cfg, block):
    """(G, E, C, d) -> (G, E, C, d), every expert on its own rows."""
    h_lin = torch.matmul(block, params.w_in)
    if is_gated(cfg.activation):
        h = activate(torch.matmul(block, params.w_gate), h_lin,
                     cfg.activation)
    else:
        h = activate(h_lin, h_lin, cfg.activation)
    del h_lin
    return torch.matmul(h, params.w_out)


def forward(params, cfg, x):
    """x (B, S, d) -> (y, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    k, e = cfg.top_k, cfg.n_experts
    g = groups(cfg, t)
    tl = t // g
    cap = capacity(cfg, tl)

    xg = x.reshape(g, tl, d)
    idx, gate, aux = route(params, cfg, xg)               # (G, Tl, k)
    flat_e, pos, keep = slots(cfg, idx, cap)              # (G, Tl·k)

    # dispatch: the kept slots' token rows, written once each
    kg, ks = torch.nonzero(keep, as_tuple=True)
    buf = torch.zeros((g, e, cap, d), dtype=x.dtype, device=x.device)
    buf[kg, flat_e[kg, ks], pos[kg, ks]] = xg[kg, ks // k]

    if cap > C_CHUNK and cap % C_CHUNK == 0:
        out_buf = torch.empty_like(buf)
        for c0 in range(0, cap, C_CHUNK):
            out_buf[:, :, c0:c0 + C_CHUNK] = _expert_ffn(
                params, cfg, buf[:, :, c0:c0 + C_CHUNK])
    else:
        out_buf = _expert_ffn(params, cfg, buf)           # (G, E, C, d)
    del buf

    # combine: each slot's expert row times its gate; dropped slots add 0
    safe_pos = torch.where(keep, pos, cap - 1)
    gi = torch.arange(g, device=x.device)[:, None]
    gathered = out_buf[gi, flat_e, safe_pos]              # (G, Tl·k, d)
    del out_buf
    w = torch.where(keep, gate.reshape(g, tl * k).to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    y = (gathered * w[..., None]).reshape(g, tl, k, d).sum(dim=2)
    return y.reshape(b, s, d), aux
