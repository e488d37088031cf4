"""Wrapper of the hand-written CUDA SSD scan kernel (csrc/ssd.cu), which
replaces the TPU kernel ``ssd_bhcqp`` (src/repro/kernels/ssd/kernel.py:74).

``ssd_scan(x, dt, a, b, c, d, *, chunk)``: the model's layout as it is.
x (Bt, L, H, P) float32 or bfloat16 with its head and head-dim axes
contiguous (a slice of the conv output, at any batch and row stride);
dt (Bt, L, H) float32, contiguous; a, d (H,) float32; b, c (Bt, L, N) in
x's dtype with N contiguous.  P in (32, 64), N in (32, 64, 128),
1 <= chunk <= 256; L need not be a multiple of ``chunk`` (the last chunk
is masked as if padded with dt = 0).  Returns y (Bt, L, H, P) in x's
dtype and the final state (Bt, H, P, N) float32.  CUDA tensors launch
the kernel, CPU tensors take the plain version
(``ref.ssd_chunked``).  Inputs that require grad raise (the kernel has
no backward; ``_build.refuse_grad``).

What bounds it on an H100 is the bytes of x and y at mamba2-780m's shape
(the tensor cores' bf16 rate for the operations).  The bf16 path
(csrc/ssd.cu has the design, PERF.md the times) is the Mamba-2 paper's
SSD algorithm in three launches on the tensor cores (``mma.sync``): each
chunk's own state, all chunks in parallel; the states passed from chunk
to chunk in order, in place in a (Bt, nc, H, P, N) float32 scratch the
wrapper allocates; the outputs, all chunks in parallel, with C·Bᵀ
computed once per (batch, chunk, 64-row query tile) for a group of 8
heads.  Every float32 operand of a product (the decay weights, the
entering state) enters as a bf16 head plus a bf16 remainder, so y stays
within one bf16 ulp of the float32 function.  The float32 path keeps the
first port's CUDA-core kernel (one block per (batch, head) walking the
chunks in order).  ``ssd_scan.launches`` counts calls, not the CUDA
kernels a call runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_chunked

HEAD_DIMS = (32, 64)              # the kernel's instantiations of P
STATE_DIMS = (32, 64, 128)        # ... and of N
MAX_CHUNK = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, a, b, c, d, chunk):
    if x.dim() != 4:
        raise ValueError(f"x must be (Bt, L, H, P), got {tuple(x.shape)}")
    bt, l, h, p = x.shape
    if b.dim() != 3:
        raise ValueError(f"b must be (Bt, L, N), got {tuple(b.shape)}")
    n = b.shape[-1]
    if x.dtype not in DTYPES:
        raise ValueError(f"x has dtype {x.dtype}, expected one of "
                         f"{list(DTYPES)}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head_dim {p} is not one of {HEAD_DIMS}")
    if n not in STATE_DIMS:
        raise ValueError(f"d_state {n} is not one of {STATE_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} is not in [1, {MAX_CHUNK}]")
    for name, v, shape, dtype in (
            ("dt", dt, (bt, l, h), torch.float32),
            ("a", a, (h,), torch.float32),
            ("b", b, (bt, l, n), x.dtype),
            ("c", c, (bt, l, n), x.dtype),
            ("d", d, (h,), torch.float32)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, expected {x.device}")
        if v.dtype != dtype:
            raise ValueError(f"{name} has dtype {v.dtype}, expected {dtype}")
        if tuple(v.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                             f"{shape}")
    for name, v in (("dt", dt), ("a", a), ("d", d)):
        if not v.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    # x, b, c: the kernel reads 16-byte pieces of each row at the given
    # batch and row strides
    for name, v, inner in (("x", x, (p, 1)), ("b", b, (1,)),
                           ("c", c, (1,))):
        shape, stride = v.shape, v.stride()
        if any(st != want and size > 1 for st, want, size in
               zip(stride[2:], inner, shape[2:])):
            raise ValueError(f"{name} is not contiguous in its last "
                             f"{len(inner)} axes (strides {stride})")
        if v.data_ptr() % 16 or any(st * v.element_size() % 16 and size > 1
                                    for st, size in zip(stride[:2],
                                                        shape[:2])):
            raise ValueError(f"{name} is not 16-byte aligned")
    return bt, l, h, p, n


def ssd_scan(x, dt, a, b, c, d, *, chunk):
    _build.refuse_grad("ssd_scan", "the model's plain chunked scan "
                       "(impl='chunked' or 'naive')", x, dt, a, b, c, d)
    bt, l, h, p, n = _check(x, dt, a, b, c, d, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, b, c, d, chunk=chunk)
    lib = _build.library()
    y = torch.empty((bt, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    # the bf16 path's scratch: each chunk's own state (Bt, nc, H, P, N)
    # float32, the entering states as bf16 head and remainder planes (the
    # same bytes) and the chunk totals (Bt, nc, H); float32 needs none
    nc = -(-l // chunk)
    n_scratch = (2 * bt * nc * h * p * n + bt * nc * h
                 if x.dtype == torch.bfloat16 else 0)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.ssd_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), state.data_ptr(),
        scratch.data_ptr() if n_scratch else None, bt, l, h, p, n, chunk,
        x.stride(0), x.stride(1), b.stride(0), b.stride(1), c.stride(0),
        c.stride(1), DTYPES[x.dtype], stream)
    _build.check(status, "ssd_launch")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
