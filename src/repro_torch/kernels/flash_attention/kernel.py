"""Wrapper of the hand-written CUDA flash-attention kernel
(csrc/flash_attention.cu).

``flash_attention_bshd(q, k, v, causal=, window=, scale=)``: the model
layout, q (B, S, H, D), k/v (B, T, K, D) with H % K == 0, q head ``h``
reading kv head ``h // (H // K)``; float32 or bfloat16, D in (64, 128,
256).  The kernel reads q, k and v at their strides, so views of the
model's tensors need no copy: D must be contiguous and every other stride
and the data pointers 16-byte aligned.  Returns a contiguous (B, S, H, D)
in q's dtype.  CUDA tensors launch the kernel (bf16 on the tensor cores,
float32 on the CUDA cores), CPU tensors take the plain version.  Inputs
that require grad raise (the kernel has no backward;
``_build.refuse_grad``).
``flash_attention_bshd.launches`` counts kernel launches.

``flash_attention_bhsd(q, k, v, ...)``: the TPU kernel's layout, q
(BH, S, D), k/v (BKH, T, D), contiguous, q row ``i`` reading kv row
``i // (BH // BKH)``; a view of the same kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (64, 128, 256)        # the kernel's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ALIGN = 16                        # bytes: the kernel's 16-byte row copies


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k and v must be 4-D (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of "
                         f"{list(DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if kh == 0 or h % kh:
        raise ValueError(f"{h} q heads do not group onto {kh} kv heads")
    for name, x, shape in (("k", k, (b, t, kh, d)), ("v", v, (b, t, kh, d))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected "
                             f"{q.dtype}")
        if x.stride(3) != 1 and d > 1:
            raise ValueError(f"{name}'s head_dim is not contiguous "
                             f"(stride {x.stride(3)})")
        size = x.element_size()
        if x.data_ptr() % ALIGN or any(
                x.stride(i) * size % ALIGN for i in range(3)
                if x.shape[i] > 1):
            raise ValueError(f"{name}'s rows are not {ALIGN}-byte aligned "
                             f"(strides {x.stride()}, pointer "
                             f"{x.data_ptr()})")
    return b, s, h, kh, t, d


def flash_attention_bshd(q, k, v, *, causal=True, window=0, scale=None):
    _build.refuse_grad("flash_attention", "the model's impl='chunked' or "
                       "'naive'", q, k, v)
    b, s, h, kh, t, d = _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale).contiguous()
    lib = _build.library()
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh,
        s, t, d, int(causal), int(window), DTYPES[q.dtype], float(scale),
        strides, stream)
    _build.check(status, "flash_attention_launch")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, scale=None):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k and v must be 3-D, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    # (BH, S, D) is the model layout of one batch row whose heads are the
    # folded (batch, head) rows, so GQA maps i -> i // group
    out = flash_attention_bshd(q.transpose(0, 1)[None],
                               k.transpose(0, 1)[None],
                               v.transpose(0, 1)[None], causal=causal,
                               window=window, scale=scale)
    return out[0].transpose(0, 1)
