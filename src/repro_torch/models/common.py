"""Shared model primitives: the weight container, init helpers, norms,
activations, RoPE / M-RoPE and default positions."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def no_constrain(x, name):
    """The models' default sharding hook: the identity (an unsharded
    model; ``distributed.sharding.ShardingRules.constrain`` is the other
    one)."""
    return x


def settled(x, whole=()):
    """``x`` with a DTensor's pending partial sums reduced (``Partial``
    placements made ``Replicate``) and the tensor dims ``whole`` gathered
    (a ``Shard`` of them made ``Replicate``); anything else as it is.
    DTensor keeps a product over a sharded contraction as a partial sum,
    which several of its rules cannot take further (an embedding's row
    mask, a product against a sequence-sharded operand)."""
    if not isinstance(x, DTensor):
        return x
    want = [Replicate() if p.is_partial()
            or (p.is_shard() and p.dim in whole) else p
            for p in x.placements]
    return x if want == list(x.placements) else \
        x.redistribute(x.device_mesh, want)


def laid_as(y, x):
    """``y`` in ``x``'s layout when both are DTensors (explicitly, so that
    autograd sees the move); anything else as it is.  An add moves its
    operands implicitly, and autograd then hands ``y`` its gradient in
    the sum's layout: a row-parallel product's output added to a
    sequence-sharded residual would get a sequence-sharded gradient,
    which the product's backward must flatten (torch 2.11's DTensor
    flattens only a leading sharded dim)."""
    if isinstance(y, DTensor) and isinstance(x, DTensor) \
            and y.placements != x.placements:
        return y.redistribute(x.device_mesh, x.placements)
    return y


def batch_local(fn, *args):
    """``fn(*args)`` on each rank's own batch rows, where every DTensor
    among ``args`` is batch-sharded (``Shard(0)``, all alike) or
    replicated; None where they are laid out otherwise or none is a
    DTensor (the caller then runs ``fn`` as it is).  ``fn`` must keep
    batch rows apart and return a tensor, or a tuple of them, batch
    leading: each comes back batch-sharded.  A replicated argument's
    gradient is each rank's partial sum over its rows.  DTensor's
    products flatten the batch with another sharded dim, which torch
    2.11's DTensor refuses; a per-row scan needs no collective at all."""
    dts = [a for a in args if isinstance(a, DTensor)]
    rows = next((a.placements for a in dts if Shard(0) in a.placements),
                None)
    if rows is None or any(
            a.placements not in (rows, (Replicate(),) * len(rows))
            for a in dts) or any(p not in (Shard(0), Replicate())
                                 for p in rows):
        return None
    mesh = dts[0].device_mesh
    shared = tuple(Partial() if p == Shard(0) else Replicate() for p in rows)
    local = [a if not isinstance(a, DTensor) else a.to_local()
             if a.placements == rows else a.to_local(grad_placements=shared)
             for a in args]
    out = fn(*local)
    wrap = lambda t: DTensor.from_local(t, mesh, rows)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def shift_right(x, i):
    """x (B, L, C) shifted i steps along L with zeros in front, as a
    concatenation (torch 2.11's DTensor takes it where its pad fails)."""
    b, l, c = x.shape
    return torch.cat([x.new_zeros((b, min(i, l), c)), x[:, :max(l - i, 0)]],
                     dim=1)


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
    own key, and fills on the device without a host copy.  None on
    ``meta`` (the dry run's abstract shapes), which has no generator and
    no values to draw."""
    if torch.device(device).type == "meta":
        return None
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


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, theta, device):
    """``rope_freqs`` as a tensor on ``device``, copied there once: a copy
    from the host inside a captured CUDA graph would wait for the device,
    which a capture refuses."""
    return torch.as_tensor(rope_freqs(head_dim, theta), device=device)


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
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
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
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
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
