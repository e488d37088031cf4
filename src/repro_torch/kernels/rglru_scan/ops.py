"""Model-facing entry point of the RG-LRU scan: the kernel for CUDA
tensors, its plain sequential version for CPU ones."""
from __future__ import annotations

from repro_torch.kernels.rglru_scan.kernel import rglru_scan


def linear_scan(a, b):
    """a, b: (B, L, D) float32. Returns h (B, L, D), h_0 = 0."""
    return rglru_scan(a.contiguous(), b.contiguous())
