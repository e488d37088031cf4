"""Wrapper of the hand-written CUDA noma_rate kernel (csrc/noma_rate.cu).

``noma_rate(contrib, sig, group_end, inter, bw)``: (B, M, U) float32
inputs in SIC-sorted order, int32 keys, ``bw`` a (B,) float32 tensor;
returns the (B, M, U) rates.  CUDA tensors launch the kernel, CPU tensors
take the plain version; inputs that require grad raise (the kernel has
no backward).  ``noma_rate.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.noma_rate.ref import noma_rate_ref

SMEM_LIMIT = 232448               # bytes a block may use on sm_90
SCAN_SMEM = 64 * 4                # the segmented scan's carries


def _check(contrib, sig, group_end, inter, bw):
    if contrib.dim() != 3:
        raise ValueError(f"contrib must be (B, M, U), got "
                         f"{tuple(contrib.shape)}")
    b, m, u = contrib.shape
    dev = contrib.device
    for name, x, dtype, shape in (
            ("contrib", contrib, torch.float32, (b, m, u)),
            ("sig", sig, torch.float32, (b, m, u)),
            ("group_end", group_end, torch.int32, (b, m, u)),
            ("inter", inter, torch.float32, (b, m, u)),
            ("bw", bw, torch.float32, (b,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if 2 * u * 4 + SCAN_SMEM > SMEM_LIMIT:
        raise ValueError(f"U={u} does not fit one block's shared memory")
    return b, m, u


def noma_rate(contrib, sig, group_end, inter, bw):
    """Per-(channel, sorted-user) SIC uplink rates for B cells."""
    _build.refuse_grad("noma_rate", "core.noma.uplink_rates", contrib, sig,
                       inter, bw)
    b, m, u = _check(contrib, sig, group_end, inter, bw)
    if contrib.device.type == "cpu":
        return noma_rate_ref(contrib, sig, group_end, inter, bw)
    # the kernel's segmented scan needs equal keys in consecutive positions
    if bool((group_end[..., 1:] < group_end[..., :-1]).any()):
        raise ValueError("noma_rate kernel needs non-decreasing group keys "
                         "along each channel row")
    lib = _build.library()
    out = torch.empty_like(contrib)
    stream = torch.cuda.current_stream(contrib.device).cuda_stream
    status = lib.noma_rate_launch(
        contrib.data_ptr(), sig.data_ptr(), group_end.data_ptr(),
        inter.data_ptr(), bw.data_ptr(), out.data_ptr(), b, m, u, stream)
    _build.check(status, "noma_rate_launch")
    noma_rate.launches += 1
    return out


noma_rate.launches = 0
