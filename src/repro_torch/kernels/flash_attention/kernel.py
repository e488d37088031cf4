"""Wrapper of the hand-written CUDA flash-attention kernel
(csrc/flash_attention.cu).

``flash_attention_bhsd(q, k, v, causal=, window=, scale=)``: q (BH, S, D),
k/v (BKH, T, D) with BH % BKH == 0, the heads of each batch row h-major
so that q row ``i`` reads kv row ``i // (BH // BKH)``; float32 or bfloat16,
D in (64, 128, 256).  Returns (BH, S, D) in q's dtype.  CUDA tensors
launch the kernel, CPU tensors take the plain version.
``flash_attention_bhsd.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128, 256)        # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be 3-D, got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    bh, s, d = q.shape
    bkh, t, _ = k.shape
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of "
                         f"{list(DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if bkh == 0 or bh % bkh:
        raise ValueError(f"{bh} q rows do not group onto {bkh} kv rows")
    for name, x, shape in (("k", k, (bkh, t, d)), ("v", v, (bkh, t, d))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected "
                             f"{q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    return bh, bkh, s, t, d


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, scale=None):
    bh, bkh, s, t, d = _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        # the plain version in the model layout: one batch row whose heads
        # are the folded (batch, head) rows, so GQA maps i -> i // group
        out = attention_ref(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                            v.transpose(0, 1)[None], causal=causal,
                            window=window, scale=scale)
        return out[0].transpose(0, 1).contiguous()
    lib = _build.library()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
        bh // bkh, s, t, d, int(causal), int(window), DTYPES[q.dtype],
        float(scale), stream)
    _build.check(status, "flash_attention_launch")
    flash_attention_bhsd.launches += 1
    return out


flash_attention_bhsd.launches = 0
