"""Dense feed-forward: SwiGLU / GeGLU (gated) or plain GELU MLP."""
from __future__ import annotations

import torch

from repro_torch.models.common import Params, activate, dense_init, dtype_of


def is_gated(kind: str) -> bool:
    return kind in ("silu", "geglu")


def init(generator, cfg, device, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {
        "w_in": dense_init(generator, (d, f), dt, device),
        "w_out": dense_init(generator, (f, d), dt, device, in_axis_size=f),
    }
    if is_gated(cfg.activation):
        p["w_gate"] = dense_init(generator, (d, f), dt, device)
    return Params(**p)


def forward(params, cfg, x):
    h_lin = torch.matmul(x, params.w_in)
    if is_gated(cfg.activation):
        h = activate(torch.matmul(x, params.w_gate), h_lin, cfg.activation)
    else:
        h = activate(h_lin, h_lin, cfg.activation)
    return torch.matmul(h, params.w_out)
