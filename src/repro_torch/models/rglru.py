"""Griffin / RecurrentGemma recurrent block.

Structure (per Griffin, arXiv:2402.19427):
  x -> linear (d -> d_rnn) -> causal conv1d(w=4) -> RG-LRU -\
  x -> linear (d -> d_rnn) -> GeLU                 ---------- ⊙ -> out proj

RG-LRU:
  r_t = sigmoid(x_t W_a + b_a)            (recurrence gate)
  i_t = sigmoid(x_t W_x + b_x)            (input gate)
  log a_t = -c * softplus(Λ) * r_t
  h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Full sequences pick the recurrence by ``impl``, as the JAX block does:
``"kernel"`` runs ``rglru_scan.ops.linear_scan`` (the hand-written kernel
on a CUDA tensor, its plain sequential version on a CPU one), where JAX
says ``"pallas"``; any other ``impl`` runs the plain associative scan
(``ref.linear_scan_associative``, the counterpart of JAX's
``jax.lax.associative_scan``), which autograd differentiates: training
takes it, since the kernel refuses inputs that require grad.  ``prefill``
and serving keep the kernel.  Decode is a single step that updates its
cache in place.  Recurrence math in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import linear_scan
from repro_torch.kernels.rglru_scan.ref import linear_scan_associative
from repro_torch.models.common import (Params, dense_init, dtype_of, gelu,
                                       shift_right, sub_generator)


def init(generator, cfg, device):
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    dt = dtype_of(cfg)
    f32 = torch.float32
    # Λ init so that a^c ~ uniform(0.9, 0.999) at r=1 (Griffin appendix)
    u = torch.empty(dr, dtype=f32, device=device).uniform_(
        0.9, 0.999, generator=sub_generator(generator, device))
    lam = torch.log(torch.expm1(-torch.log(u) / cfg.rglru_c))  # inv softplus
    return Params(
        proj_rec=dense_init(generator, (d, dr), dt, device),
        proj_gate=dense_init(generator, (d, dr), dt, device),
        conv_w=dense_init(generator, (cfg.conv_width, dr), dt, device,
                          in_axis_size=cfg.conv_width),
        conv_b=torch.zeros((dr,), dtype=dt, device=device),
        w_a=dense_init(generator, (dr, dr), f32, device),
        b_a=torch.zeros((dr,), dtype=f32, device=device),
        w_x=dense_init(generator, (dr, dr), f32, device),
        b_x=torch.zeros((dr,), dtype=f32, device=device),
        lam=lam,
        out_proj=dense_init(generator, (dr, d), dt, device, in_axis_size=dr),
    )


def _causal_conv(x, w, b):
    wsize = w.shape[0]
    out = x * w[-1]
    for i in range(1, wsize):
        shifted = shift_right(x, i)
        out = out + shifted * w[-1 - i]
    return out + b


def _gates(params, cfg, xr):
    """xr (..., dr) f32 -> (a, gated_input) both f32."""
    r = torch.sigmoid(xr @ params.w_a + params.b_a)
    i = torch.sigmoid(xr @ params.w_x + params.b_x)
    log_a = -cfg.rglru_c * F.softplus(params.lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) \
        * (i * xr)
    return a, b


def _scan_branch(params, cfg, x, xr1, init_h=None, impl="kernel"):
    """The conv + RG-LRU branch times the gate branch, before out_proj.
    Returns (y in x's dtype, h (B, L, dr) float32)."""
    xr = _causal_conv(xr1, params.conv_w, params.conv_b).float()
    gate = gelu((x @ params.proj_gate).float())
    a, b = _gates(params, cfg, xr)
    if init_h is not None:
        # fold the carried state into the first step: h_1 = a_1 h_0 + b_1
        b = b.clone()
        b[:, 0] += a[:, 0] * init_h.float()
    if impl == "kernel":
        h = linear_scan(a, b)
    else:
        h = linear_scan_associative(a, b)
    return (h * gate).to(x.dtype), h


def forward(params, cfg, x, init_h=None, impl="kernel"):
    """x (B,L,d) -> (y (B,L,d), h_L (B, d_rnn) float32)."""
    y, h = _scan_branch(params, cfg, x, x @ params.proj_rec, init_h, impl)
    return y @ params.out_proj, h[:, -1]


def prefill(params, cfg, x):
    """Forward + cache capture (recurrent state + conv history)."""
    xr1 = x @ params.proj_rec                             # pre-conv
    y, h = _scan_branch(params, cfg, x, xr1)
    w = cfg.conv_width - 1
    s = x.shape[1]
    hist = xr1[:, -w:, :] if s >= w else F.pad(xr1, (0, 0, w - s, 0))
    return y @ params.out_proj, {"conv": hist, "h": h[:, -1]}


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch, dtype=None, *, device):
    dr = cfg.resolved_d_rnn
    dt = dtype or dtype_of(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dt,
                            device=device),
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
    }


def decode_step(params, cfg, x, cache):
    """x (B,1,d) -> (y (B,1,d), cache).  The cache's ``conv`` and ``h``
    are updated in place and come back as the same tensors (a captured
    step reads and writes the same memory on every replay)."""
    xr1 = (x @ params.proj_rec)[:, 0]                      # (B, dr)
    hist = torch.cat([cache["conv"], xr1[:, None, :]], dim=1)
    conv_out = torch.einsum("bwr,wr->br", hist, params.conv_w) + params.conv_b
    xr = conv_out.float()
    gate = gelu((x @ params.proj_gate)[:, 0].float())
    a, b = _gates(params, cfg, xr)
    h = a * cache["h"] + b
    y = (h * gate).to(x.dtype)
    y = (y @ params.out_proj)[:, None, :]
    cache["conv"].copy_(hist[:, 1:, :])
    cache["h"].copy_(h)
    return y, cache
