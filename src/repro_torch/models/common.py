"""Shared model primitives: the weight container, init helpers, norms,
activations, RoPE / M-RoPE and default positions."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class Params(nn.Module):
    """Named weight tensors and named sub-modules: the counterpart of one
    dict of the JAX package's params pytree, under the same names.  The
    weights are made frozen (``requires_grad=False``), so serving records
    no autograd graph; the train state (``launch.steps.init_train_state``,
    ``interop.train_state_from_numpy``) turns ``requires_grad_(True)``
    on."""

    def __init__(self, **items):
        super().__init__()
        for name, v in items.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def sub_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from the host ``generator``: each
    tensor draws its own stream, as ``jax.random.split`` gives each leaf its
    own key, and fills on the device without a host copy."""
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(generator, shape, dtype, device, in_axis_size=None):
    """Truncated-normal fan-in init: a standard normal cut at ±2, times
    ``1/sqrt(fan_in)``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                          generator=sub_generator(generator, device))
    return t.mul_(std).to(dtype)


# --------------------------------------------------------------------------- #
# norms / activations
# --------------------------------------------------------------------------- #
def rms_norm(x, weight, eps, gemma_style=False):
    x32 = x.float()
    var = torch.mean(x32.square(), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = weight.float()
    y = y * (1.0 + w) if gemma_style else y * w
    return y.to(x.dtype)


def gelu(x):
    """The tanh approximation, ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def activate(x_gate, x_lin, kind):
    """Gated activation: silu (SwiGLU) / geglu / plain gelu."""
    if kind == "silu":
        return F.silu(x_gate) * x_lin
    if kind == "geglu":
        return gelu(x_gate) * x_lin
    if kind == "gelu":
        return gelu(x_gate)  # non-gated
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim, theta):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0
                            / head_dim))


def _rotate(x, angles):
    """Rotate the two halves of x's last axis by ``angles`` (..., S, 1,
    half), in float32, and cast back."""
    half = x.shape[-1] // 2
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D); positions: broadcastable to (..., S) integers."""
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta), device=x.device)
    angles = positions[..., None].float() * freqs       # (..., S, half)
    return _rotate(x, angles[..., None, :])


def apply_mrope(x, positions, theta, sections):
    """Qwen2-VL multimodal RoPE.

    x: (..., S, H, D); positions: (..., 3, S) — t/h/w position ids.
    ``sections`` partitions the half dim; frequencies for section j rotate
    by positions[j]."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = torch.as_tensor(rope_freqs(x.shape[-1], theta), device=x.device)
    parts, start = [], 0
    for j, sec in enumerate(sections):
        pos_j = positions[..., j, :]                    # (..., S)
        parts.append(pos_j[..., None].float() * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1)[..., None, :])


def positions_for(cfg, batch, seq, offset=0, *, device):
    """Default (text-only) position ids; M-RoPE archs replicate across
    t/h/w."""
    pos = torch.arange(seq, dtype=torch.int64, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections is not None:
        return pos[:, None, :].expand(batch, 3, seq)
    return pos
