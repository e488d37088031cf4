"""Plain reference of Granite 4.0-H (model_type ``granitemoehybrid``) as a
language model, after transformers' ``modeling_granitemoehybrid.py``:

    h_0 = embedding_multiplier · E[x]
    each layer l:  a = mixer_l(RMSNorm(h));   h <- h + residual_multiplier · a
                   u = RMSNorm(h)
                   m = Σ_{e ∈ top-k} g_e · SwiGLU_e(u) + SwiGLU_shared(u)
                   h <- h + residual_multiplier · m
    logits = RMSNorm(h) · Eᵀ / logits_scaling          (E tied)

- g: the softmax over the k largest of the router's logits (equal to a
  softmax over every expert, the k largest kept and renormalised);
- mixer "attention": causal GQA, no position embedding (NoPE), scores
  scaled by ``attention_multiplier``, no bias;
- mixer "mamba": Mamba-2 with one group: in_proj -> (z, xBC, dt); a
  causal depthwise conv with bias over xBC, then silu; dt =
  softplus(dt + dt_bias), A = -exp(A_log); the SSD with the D skip; the
  gated RMSNorm rmsnorm(y · silu(z)) · w over all the inner channels;
  out_proj; no projection bias;
- SwiGLU(u) = (silu(u W_gate) ⊙ u W_in) W_out.

Plain ``torch`` in float32 with TF32 off (matmul and cuDNN); the SSD in
float64 by the block decomposition of ``reference/mamba2.py`` (its
``ssd``).  No cache, no batching tricks, no capacity: each call runs
whole sequences, teacher-forced, a layer at a time, every route
computed, each expert a loop over the tokens routed to it.  The causal
scores are computed a block of query rows at a time.  ``quant`` (the
control) rounds the operands of every matrix product to a lower
precision (the SSD's products excepted, as in ``reference/mamba2.py``).

``cfg`` is the benchmark's configuration (``configs/granite-*.json``),
read under the published config's own keys.  Weights are the dict the
benchmark made (``paths/serve_granite.py``): one dict a layer, in the
served dtype (the router float32); one layer at a time is converted to
float32 and let go after; nothing is changed in place.

Departures from the published model: depth (the configuration's
``num_hidden_layers``); random weights from the seed; the router's
softmax, top-k and renormalisation in float32, equal probabilities
keeping the lower expert first (a stable sort).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.mamba2 import ssd

# query rows a block of the causal scores holds
ROW_BLOCK = 1024


def _keep(x):
    return x


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def head_dim(cfg) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def attention(h, lw, cfg, q):
    """Causal GQA with no position embedding over whole sequences: h (R,
    L, d) -> (R, L, d)."""
    r, l, d = h.shape
    nh, nk, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        head_dim(cfg)
    g = nh // nk
    mm = lambda x, w: q(x) @ q(w)
    xq = mm(h, lw["wq"].reshape(d, nh * hd)).reshape(r, l, nh, hd)
    xk = mm(h, lw["wk"].reshape(d, nk * hd)).reshape(r, l, nk, hd)
    xv = mm(h, lw["wv"].reshape(d, nk * hd)).reshape(r, l, nk, hd)
    scale = cfg["attention_multiplier"]
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


def mamba(h, lw, cfg, q):
    """The Mamba-2 mixer over whole sequences: h (R, L, d) -> (R, L, d)."""
    r, l, _ = h.shape
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    n, p = cfg["mamba_d_state"], cfg["mamba_d_head"]
    nh = cfg["mamba_n_heads"]
    width = cfg["mamba_d_conv"]
    mm = lambda x, w: q(x) @ q(w)
    zxbcdt = mm(h, lw["in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    cw = lw["conv_w"]                                        # (W, Dc)
    conv = xbc * cw[-1]
    for j in range(1, width):
        conv = conv + F.pad(xbc, (0, 0, j, 0))[:, :l] * cw[-1 - j]
    xbc = F.silu(conv + lw["conv_b"])
    xs = xbc[..., :di].reshape(r, l, nh, p)
    bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt + lw["dt_bias"])
    a = -torch.exp(lw["A_log"])
    f64 = lambda v: v.to(torch.float64)
    y = ssd(f64(xs), f64(dt), f64(a), f64(bm), f64(cm), f64(lw["D"]),
            cfg["mamba_chunk_size"]).to(torch.float32)
    y = rms_norm(y.reshape(r, l, di) * F.silu(z), lw["norm_w"],
                 cfg["rms_norm_eps"])
    return mm(y, lw["out_proj"])


def swiglu(x, w_gate, w_in, w_out, q):
    return (q(F.silu(q(x) @ q(w_gate)) * (q(x) @ q(w_in)))) @ q(w_out)


def moe(u, lw, cfg, q):
    """The FFN over tokens u (T, d): the routed experts, every route
    computed, each expert on the tokens routed to it, plus the shared
    expert on every token.  Returns (m (T, d), the experts (T, k) each
    token was routed to)."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(q(u) @ q(lw["router"]), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[:, :k], order[:, :k]
    gate = gate / gate.sum(-1, keepdim=True)
    y = torch.zeros_like(u)
    for e in range(cfg["num_local_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(u[tok], lw["w_gate"][e], lw["w_in"][e], lw["w_out"][e],
                     q)
        y.index_add_(0, tok, out * gate[tok, slot, None])
    return y + swiglu(u, lw["shared_gate"], lw["shared_in"],
                      lw["shared_out"], q), idx


def embed(w, cfg, tokens):
    """The float32 embedding rows of ``tokens`` (R, L), times the
    embedding multiplier."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return w["embed"][tokens].to(torch.float32) * cfg["embedding_multiplier"]


def layer(w, cfg, i):
    """Layer i's weights in float32 (a copy; the served ones unchanged)
    and its mixer's kind under ``"kind"`` ("mamba" or "attention")."""
    out = {name: v.to(torch.float32) for name, v in w["layers"][i].items()}
    out["kind"] = cfg["layer_types"][i]
    return out


def mixer(x, lw, cfg, quant=None):
    """The layer's mixer on its normed input: a = mixer(RMSNorm(x))."""
    q = quant or _keep
    run = {"mamba": mamba, "attention": attention}[lw["kind"]]
    return run(rms_norm(x, lw["norm1"], cfg["rms_norm_eps"]), lw, cfg, q)


def block(x, lw, cfg, quant=None, a=None):
    """One layer on the residual stream x (R, L, d): (its output, the
    experts (R·L, k) each token was routed to).  ``a``: the layer's
    ``mixer`` output, where the caller has it."""
    q = quant or _keep
    r, l, d = x.shape
    eps, res = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = x + res * (mixer(x, lw, cfg, quant) if a is None else a)
    m, idx = moe(rms_norm(x, lw["norm2"], eps).reshape(r * l, d), lw, cfg,
                 q)
    return x + res * m.reshape(r, l, d), idx


def head(w, cfg, x, first, quant=None):
    """Float32 logits (R, L - first, V) of the final stream x at
    positions first..L-1: the tied head over the logits scaling."""
    q = quant or _keep
    x = rms_norm(x[:, first:], w["final_norm"].to(torch.float32),
                 cfg["rms_norm_eps"])
    return (q(x) @ q(w["embed"].to(torch.float32).t())) \
        / cfg["logits_scaling"]


def served(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
           quant=None):
    """The full forward of ``tokens`` (R, L): float32 logits (R, L -
    first, V) at positions first..L-1, and the experts (R, n_layers,
    L - first, k) each layer routes those positions to."""
    r, l = tokens.shape
    x = embed(w, cfg, tokens)
    routes = []
    for i in range(cfg["num_hidden_layers"]):
        x, idx = block(x, layer(w, cfg, i), cfg, quant)
        routes.append(idx.view(r, l, -1)[:, first:])
    return head(w, cfg, x, first, quant), torch.stack(routes, 1)


def logits_at(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
              quant=None) -> torch.Tensor:
    """Float32 logits (R, L - first, V) at positions first..L-1 of
    ``tokens`` (R, L)."""
    return served(w, cfg, tokens, first, quant)[0]
