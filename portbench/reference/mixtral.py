"""Plain reference of Mixtral (arXiv:2401.04088) as a language model:
token embedding; per layer, RMSNorm -> grouped-query attention with RoPE
over the whole causal context -> residual -> RMSNorm -> softmax router
over the experts -> top-k -> gates renormalised over the k -> for each
expert, SwiGLU on the tokens routed to it -> the gate-weighted sum ->
residual; then the final RMSNorm and the untied LM head.

Plain ``torch`` in float32 with TF32 off (matmul and cuDNN).  No cache, no
batching tricks, no capacity: each call runs whole sequences,
teacher-forced, every route computed.  The causal scores are computed a
block of query rows at a time (each block against the keys up to its
last row), so that an S x S score matrix never exists.  ``quant`` (the
control) rounds the operands of every matrix product to a lower
precision.

Weights are the dict the benchmark made (``paths/serve_mixtral.py``):
stacked per layer, in the served dtype (the router in float32).  One
layer at a time is converted to float32 and let go after, so a float32
copy of every layer never exists; nothing is changed in place.

Departures from the published description (Mixtral-8x22B's config.json
and the paper):
- depth: the configuration's ``n_layers`` (7 of 56), the stage of a
  pipeline that one card holds;
- weights: random from the seed, not the published checkpoint;
- RoPE rotates the two halves of each head (the published checkpoint's
  layout, as in its reference code), with frequencies theta^(-2i/hd)
  rounded to float32;
- the router's softmax, top-k and renormalisation in float32; equal
  probabilities keep the lower expert first (a stable sort).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# query rows a block of the causal scores holds
ROW_BLOCK = 1024


def _keep(x):
    return x


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (R, L, heads, hd) at positions 0..L-1, the two halves rotated."""
    l, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) * 2.0 / hd)
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] \
        * freqs                                         # (L, half)
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h, lw, cfg, q):
    """Causal GQA over whole sequences: h (R, L, d) -> (R, L, d)."""
    r, l, d = h.shape
    nh, nk, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    g = nh // nk
    mm = lambda x, w: q(x) @ q(w)
    xq = rope(mm(h, lw["wq"].reshape(d, nh * hd)).reshape(r, l, nh, hd),
              cfg["rope_theta"])
    xk = rope(mm(h, lw["wk"].reshape(d, nk * hd)).reshape(r, l, nk, hd),
              cfg["rope_theta"])
    xv = mm(h, lw["wv"].reshape(d, nk * hd)).reshape(r, l, nk, hd)
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty((r, l, nk, g, hd), dtype=h.dtype, device=h.device)
    for b in range(r):
        k_b, v_b = xk[b].transpose(0, 1), xv[b].transpose(0, 1)  # (K, L, hd)
        for i0 in range(0, l, ROW_BLOCK):
            i1 = min(i0 + ROW_BLOCK, l)
            qb = xq[b, i0:i1].reshape(i1 - i0, nk, g, hd).permute(1, 2, 0, 3)
            s = q(qb) @ q(k_b[:, None, :i1]).transpose(-1, -2) * scale
            rows = torch.arange(i0, i1, device=h.device)[:, None]
            keys = torch.arange(i1, device=h.device)[None, :]
            s = s.masked_fill(keys > rows, float("-inf"))
            p = torch.softmax(s, dim=-1)                  # (K, g, rows, keys)
            out[b, i0:i1] = (q(p) @ q(v_b[:, None, :i1])).permute(2, 0, 1, 3)
    return mm(out.reshape(r, l, nh * hd), lw["wo"].reshape(nh * hd, d))


def moe(h, lw, cfg, q):
    """The sparse FFN over tokens h (T, d): every route computed, each
    expert on the tokens routed to it.  Returns (y (T, d), the experts
    (T, k) each token was routed to)."""
    k = cfg["top_k"]
    probs = torch.softmax(q(h) @ q(lw["router"]), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], order[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(cfg["n_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        a = F.silu(q(x) @ q(lw["w_gate"][e])) * (q(x) @ q(lw["w_in"][e]))
        y.index_add_(0, tok, (q(a) @ q(lw["w_out"][e])) * gate[tok, slot,
                                                                None])
    return y, idx


def embed(w, tokens):
    """The float32 embedding rows of ``tokens`` (R, L)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return w["embed"][tokens].to(torch.float32)


def layer(w, i):
    """Layer i's weights in float32 (a copy; the served ones unchanged)."""
    return {name: v[i].to(torch.float32) for name, v in w["layers"].items()}


def block(x, lw, cfg, quant=None):
    """One layer on the residual stream x (R, L, d): (its output, the
    experts (R·L, k) each token was routed to)."""
    q = quant or _keep
    r, l, d = x.shape
    eps = cfg["norm_eps"]
    x = x + attention(rms_norm(x, lw["norm1"], eps), lw, cfg, q)
    y, idx = moe(rms_norm(x, lw["norm2"], eps).reshape(r * l, d), lw, cfg,
                 q)
    return x + y.reshape(r, l, d), idx


def head(w, cfg, x, first, quant=None):
    """Float32 logits (R, L - first, V) of the final stream x at
    positions first..L-1."""
    q = quant or _keep
    x = rms_norm(x[:, first:], w["final_norm"].to(torch.float32),
                 cfg["norm_eps"])
    return q(x) @ q(w["lm_head"].to(torch.float32))


def served(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
           quant=None):
    """The full forward of ``tokens`` (R, L): float32 logits (R, L -
    first, V) at positions first..L-1, and the experts (R, n_layers,
    L - first, k) each layer routes those positions to."""
    r, l = tokens.shape
    x = embed(w, tokens)
    routes = []
    for i in range(cfg["n_layers"]):
        x, idx = block(x, layer(w, i), cfg, quant)
        routes.append(idx.view(r, l, -1)[:, first:])
    return head(w, cfg, x, first, quant), torch.stack(routes, 1)


def logits_at(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
              quant=None) -> torch.Tensor:
    """Float32 logits (R, L - first, V) at positions first..L-1 of
    ``tokens`` (R, L)."""
    return served(w, cfg, tokens, first, quant)[0]
