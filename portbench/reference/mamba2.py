"""Plain reference of Mamba-2 (arXiv:2405.21060) as a language model:
token embedding, blocks of [RMSNorm -> in_proj -> causal depthwise conv
(silu) over (x, B, C) -> SSD -> gated RMSNorm -> out_proj] with a residual,
a final RMSNorm and the embedding as the LM head (tied).

Plain ``torch`` in float32 with TF32 off; the SSD in float64 by its block
decomposition (a quadratic form inside each chunk, the state carried
between chunks).  No cache, no batching of requests of different lengths:
each call runs whole sequences, teacher-forced.  ``quant`` (the control)
rounds every matrix product's operands to a lower precision.

Weights are the dict the benchmark made (``paths/serve.py``): stacked per
layer, in the served dtype; this module upcasts them and changes nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _keep(x):
    return x


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def ssd(x, dt, a, b, c, d, chunk):
    """y_t = Σ_{s<=t} (C_t·B_s) exp(Σ_{r=s+1..t} dt_r a) dt_s x_s + d x_t.
    x (R, L, H, P), dt (R, L, H), a, d (H,), b, c (R, L, N); float64."""
    r, l, h, p = x.shape
    n = b.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    padl = lambda v: F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
    xs = padl(x).reshape(r, nc, chunk, h, p)
    dts = padl(dt).reshape(r, nc, chunk, h)
    bs = padl(b).reshape(r, nc, chunk, n)
    cs = padl(c).reshape(r, nc, chunk, n)
    la = torch.cumsum(dts * a, dim=2)                      # (R,nc,Q,H)
    xdt = xs * dts[..., None]
    causal = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                   device=x.device))
    state = x.new_zeros((r, h, p, n))
    ys = []
    for k in range(nc):
        seg = la[:, k, :, None, :] - la[:, k, None, :, :]    # (R,i,j,H)
        decay = torch.where(causal[None, :, :, None], torch.exp(seg),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        g = torch.einsum("rin,rjn->rij", cs[:, k], bs[:, k])
        y = torch.einsum("rijh,rjhp->rihp", g[..., None] * decay, xdt[:, k])
        y = y + torch.einsum("rin,rhpn->rihp", cs[:, k], state) \
            * torch.exp(la[:, k])[..., None]
        ys.append(y)
        to_end = torch.exp(la[:, k, -1:, :] - la[:, k])     # (R,Q,H)
        state = (torch.exp(la[:, k, -1])[:, :, None, None] * state
                 + torch.einsum("rjhp,rjn->rhpn", xdt[:, k] * to_end[..., None],
                                bs[:, k]))
    y = torch.cat(ys, dim=1)[:, :l]
    return y + x * d[None, None, :, None]


def logits_at(w: dict, cfg: dict, tokens: torch.Tensor, first: int,
              quant=None) -> torch.Tensor:
    """Float32 logits (R, L - first, V) at positions first..L-1 of
    ``tokens`` (R, L)."""
    q = quant or _keep
    f32 = torch.float32
    eps = cfg["norm_eps"]
    d_inner = cfg["expand"] * cfg["d_model"]
    n, hd = cfg["d_state"], cfg["head_dim"]
    h = d_inner // hd
    width = cfg["conv_width"]
    r, l = tokens.shape
    mm = lambda x, wt: q(x) @ q(wt.to(f32))
    x = w["embed"][tokens].to(f32)
    for i in range(cfg["n_layer"]):
        lw = {k: v[i] for k, v in w["layers"].items()}
        hin = rms_norm(x, lw["norm1"].to(f32), eps)
        zxbcdt = mm(hin, lw["in_proj"])
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
        dt = zxbcdt[..., 2 * d_inner + 2 * n:]
        cw = lw["conv_w"].to(f32)                                  # (W, Dc)
        conv = xbc * cw[-1]
        for j in range(1, width):
            conv = conv + F.pad(xbc, (0, 0, j, 0))[:, :l] * cw[-1 - j]
        xbc = F.silu(conv + lw["conv_b"].to(f32))
        xs = xbc[..., :d_inner].reshape(r, l, h, hd)
        bm, cm = xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]
        dt = F.softplus(dt + lw["dt_bias"].to(f32))
        a = -torch.exp(lw["A_log"].to(f32))
        f64 = lambda v: v.to(torch.float64)
        y = ssd(f64(xs), f64(dt), f64(a), f64(bm), f64(cm),
                f64(lw["D"].to(f32)), cfg["chunk_size"]).to(f32)
        y = rms_norm(y.reshape(r, l, d_inner) * F.silu(z),
                     lw["norm_w"].to(f32), eps)
        x = x + mm(y, lw["out_proj"])
    x = rms_norm(x[:, first:], w["final_norm"].to(f32), eps)
    return mm(x, w["embed"].t())
