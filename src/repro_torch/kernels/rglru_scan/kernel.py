"""Wrapper of the hand-written CUDA RG-LRU scan kernel (csrc/rglru_scan.cu).

``rglru_scan(a, b)``: a, b (B, L, D) float32; returns h (B, L, D) with
h_t = a_t·h_{t-1} + b_t from h_0 = 0.  CUDA tensors launch the kernel,
CPU tensors take the plain version.  Inputs that require grad raise
(the kernel has no backward; ``_build.refuse_grad``).
``rglru_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import linear_scan_sequential


def _check(a, b):
    if a.dim() != 3:
        raise ValueError(f"a must be (B, L, D), got {tuple(a.shape)}")
    for name, x in (("a", a), ("b", b)):
        if x.device != a.device:
            raise ValueError(f"{name} is on {x.device}, expected {a.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {x.dtype}, expected "
                             "torch.float32")
        if x.shape != a.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(a.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return a.shape


def rglru_scan(a, b):
    _build.refuse_grad("rglru_scan", "the model's plain scan (rglru.forward "
                       "with impl='naive' or 'chunked')", a, b)
    bt, l, d = _check(a, b)
    if a.device.type == "cpu":
        return linear_scan_sequential(a, b)
    lib = _build.library()
    h = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = lib.rglru_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                   bt, l, d, stream)
    _build.check(status, "rglru_scan_launch")
    rglru_scan.launches += 1
    return h


rglru_scan.launches = 0
