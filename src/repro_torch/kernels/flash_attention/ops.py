"""Model-layout entry point of the flash-attention kernel: q (B,S,H,D),
k/v (B,T,K,D) go to the kernel as they are, read at their strides."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q (B,S,H,D); k/v (B,T,K,D), H % K == 0. Returns (B,S,H,D).

    q head ``h`` reads kv head ``h // (H/K)`` in place: k and v are never
    repeated across the group, and no layout copy is made."""
    return flash_attention_bshd(q, k, v, causal=causal, window=window,
                                scale=scale)
