"""Plain PyTorch versions of the Mamba-2 mixer's two elementwise passes.

The model's plain ops, exactly, in their order (``models.ssm`` takes them
off the card, on a mesh, in the dry run and in training):

- ``causal_conv_silu_ref(xbc, w, b)``: the depthwise causal conv over
  xbc (B, L, C) with taps w (W, C), as shifted adds (the newest tap
  first, zeros before position 0 of each batch row), then the bias and
  SiLU.  In the inputs' dtype: a bf16 input rounds after every product
  and sum.
- ``gated_rms_norm_ref(y, z, w, eps)``: y (B, L, C) gated by silu(z), the
  gate rounded to y's dtype and multiplied in it, then ``rms_norm`` (the
  mean of squares in float32, the weight applied in float32, rounded to
  y's dtype once).

Cast the inputs to float32 to get the float32 version the kernels are
held to.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import rms_norm, shift_right


def causal_conv_silu_ref(xbc, w, b):
    wsize = w.shape[0]
    out = xbc * w[-1]
    for i in range(1, wsize):
        shifted = shift_right(xbc, i)
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def gated_rms_norm_ref(y, z, w, eps):
    return rms_norm(y * F.silu(z.float()).to(y.dtype), w, eps)
