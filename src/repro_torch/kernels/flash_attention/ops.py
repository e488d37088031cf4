"""Model-layout entry point of the flash-attention kernel: (B,S,H,D) ->
the kernel's (B·H, S, D) layout with GQA folded into the row order, and
back."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q (B,S,H,D); k/v (B,T,K,D), H % K == 0. Returns (B,S,H,D).

    The kernel's leading axis is (batch, head), h-major, so q row
    ``b·H + h`` reads kv row ``b·K + h // (H/K)``: k and v are never
    repeated across the group."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    fold = lambda x, n, length: x.transpose(1, 2).reshape(
        b * n, length, d).contiguous()
    out = flash_attention_bhsd(fold(q, h, s), fold(k, kh, t), fold(v, kh, t),
                               causal=causal, window=window, scale=scale)
    return out.reshape(b, h, s, d).transpose(1, 2)
