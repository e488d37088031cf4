"""Hand-rolled AdamW + schedule, written as the JAX package writes it.

``torch.optim.AdamW`` is not used: it adds epsilon and applies the
weight decay elsewhere than JAX's update.  Here each leaf takes, in
float32, ``g·scale`` with ``scale = min(1, clip/(‖g‖+1e-9))``, the moment
updates, and ``p - lr·(m̂/(√v̂+eps) + wd·p)``, cast back to the parameter's
dtype.

State: ``OptState(step, m, v)`` with ``step`` a 0-d int32 tensor and
``m``/``v`` float32 tensors keyed by parameter name, in the order of
the params mapping they were made from.  ``apply`` updates the
parameters, ``m`` and ``v`` in place (what JAX's buffer donation
reuses) and returns them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def init(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero moments, float32, each laid out as its parameter (on its
    device; a DTensor parameter's moments are sharded as it is)."""
    dev = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32,
                                         requires_grad=False)
                     for k, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=zeros(), v=zeros())


def schedule(cfg: AdamWConfig, step):
    """Linear warmup -> cosine decay to min_lr_frac·lr (float32)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tensors):
    """√(Σ x²) over every tensor, in float32."""
    total = 0.0
    for x in tensors:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
          grads: Mapping[str, torch.Tensor], state: OptState):
    """Returns (params, new_state, metrics); the parameters and the
    moments are updated in place, one leaf at a time (a leaf's float32
    temporaries, never the whole model's)."""
    gnorm = global_norm(grads[k] for k in params)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.m[k], state.v[k]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
