"""Model-facing entry points of the Mamba-2 mixer's elementwise passes,
and the one rule of where their kernels run (``use_kernels``): under
``impl="kernel"`` on plain CUDA tensors.  Everywhere else (the CPU, meta
tensors in the dry run, DTensors on a mesh, training's other impls) the
plain versions of ``ref`` run, bitwise the model's plain ops."""
from __future__ import annotations

from torch.distributed.tensor import DTensor

from repro_torch.kernels.ssm_mixer import kernel, ref


def use_kernels(impl, *tensors):
    """Whether a pass over ``tensors`` under ``impl`` runs as its
    hand-written kernel."""
    return impl == "kernel" and all(
        t.device.type == "cuda" and not isinstance(t, DTensor)
        for t in tensors)


def causal_conv_silu(xbc, w, b, impl):
    """silu(causal depthwise conv(xbc, w) + b): xbc (B, L, C), read in
    place at its strides; w (W, C); b (C,).  Returns (B, L, C)."""
    if use_kernels(impl, xbc, w, b):
        return kernel.causal_conv_silu(xbc, w, b)
    return ref.causal_conv_silu_ref(xbc, w, b)


def gated_rms_norm(y, z, w, eps, impl):
    """rms_norm(y · silu(z)) · w: y, z (B, L, C); w (C,).  Returns
    (B, L, C) in y's dtype."""
    if use_kernels(impl, y, z, w):
        return kernel.gated_rms_norm(y, z, w, eps)
    return ref.gated_rms_norm_ref(y, z, w, eps)
