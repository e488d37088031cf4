"""Model-layout entry point of the decode-attention kernel: the new
token's q (B, 1, H, D) against an attention layer's ring cache (the dict
``models.attention.init_cache`` makes: ``k``, ``v`` (B, T, K, D) and
``pos`` (T,)), read where it lies."""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import decode_attention \
    as _kernel


def decode_attention(q, cache, pos, *, window=0, scale=None):
    """q (B, 1, H, D) at position ``pos`` (0-d int64 on q's device)
    against ``cache``, whose slots hold the keys of the positions in
    ``cache["pos"]``.  Returns (B, 1, H, D)."""
    return _kernel(q, cache["k"], cache["v"], cache["pos"], pos,
                   window=window, scale=scale)
