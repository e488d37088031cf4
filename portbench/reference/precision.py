"""Lower precisions that the controls compute in, emulated on float32.

``tf32``: the 10 explicit mantissa bits of TF32 (round to nearest even),
the step below float32 with TF32 off.  ``fp8``: float8 e4m3 with a scale
per row of the last axis (amax to 448), the step below bfloat16.  Both pass
the gradient straight through.
"""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float().contiguous()
    i = x32.view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    r = torch.where(torch.isfinite(x32), r, x32)
    return x32 + (r - x32).detach()


def fp8(x: torch.Tensor) -> torch.Tensor:
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = amax / 448.0
    q = (x32 / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x32 + (q - x32).detach()
