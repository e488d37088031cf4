"""Train / prefill / decode step builders (the port of the JAX package's
``launch/steps.py``).

INPUT SHAPES (assigned):
  train_4k     seq 4096,    global batch 256   -> train_step
  prefill_32k  seq 32768,   global batch 32    -> prefill_step (forward)
  decode_32k   KV 32768,    global batch 128   -> decode_step (1 new token)
  long_500k    KV 524288,   global batch 1     -> decode_step, sub-quadratic
                                                  archs only

The train step is eager: autograd through the model's plain paths
(``impl="chunked"`` or ``"naive"``; the kernels refuse gradients), then
``optim.apply`` on the state in place under ``no_grad``, which stands in
for JAX's donated buffers.  ``input_specs`` and the ``abstract_*``
shapes, which only the JAX dry run reads, are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.training import losses, optim

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

MOE_AUX_WEIGHT = 0.01

# per-arch microbatch counts for train_4k (global batch 256), the JAX
# package's: they keep MoE dispatch buffers and logits inside a TPU
# chip's 16 GiB
MICROBATCHES = {
    "dbrx-132b": 32,
    "mixtral-8x22b": 32,
    "qwen2-vl-72b": 16,
    "llama3-8b": 2,
    "gemma3-12b": 8,
    "gemma-2b": 2,
    "recurrentgemma-2b": 2,
}


def shape_applicable(cfg, shape_name: str) -> bool:
    """long_500k only runs for sub-quadratic attention."""
    if shape_name != "long_500k":
        return True
    if cfg.is_subquadratic:
        return True
    n_global = sum(1 for m, _ in cfg.layer_specs if m == "attn")
    return n_global * 6 <= cfg.n_layers  # ≥5:1 local:global


def _model_inputs(batch):
    kw = {}
    if "vision_embeds" in batch:
        kw["vision_embeds"] = batch["vision_embeds"]
        kw["positions"] = batch.get("positions")
    return kw


def make_grad_fn(cfg, impl="chunked", microbatches=None,
                 accum_dtype=torch.float32):
    """``grad_fn(params, batch) -> (total, loss, grads)``: autograd of
    ``total = loss + MOE_AUX_WEIGHT·aux`` (remat on), the body JAX's
    ``make_train_step`` differentiates; grads keyed by parameter name.
    With ``nm > 1`` microbatches the batch splits on its leading axis,
    gradients accumulate in ``accum_dtype`` and the sums are divided by
    ``nm``, as JAX's ``lax.scan`` does."""
    nm = microbatches or MICROBATCHES.get(cfg.name, 1)

    def value_and_grad(params, batch):
        names, ps = zip(*params.named_parameters())
        logits, aux = T.forward(params, cfg, batch["tokens"], impl=impl,
                                remat=True, **_model_inputs(batch))
        loss = losses.lm_loss(cfg, logits, batch["labels"])
        del logits
        total = loss + MOE_AUX_WEIGHT * aux
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(ps, gs)]
        return total.detach(), loss.detach(), dict(zip(names, gs))

    def grad_fn(params, batch):
        if nm == 1:
            return value_and_grad(params, batch)
        mbs = {k: x.reshape((nm, x.shape[0] // nm) + x.shape[1:])
               for k, x in batch.items()}
        grads, total, loss = None, 0.0, 0.0
        for i in range(nm):
            t, l, g = value_and_grad(params, {k: x[i]
                                              for k, x in mbs.items()})
            if grads is None:
                grads = {k: torch.zeros(x.shape, dtype=accum_dtype,
                                        device=x.device)
                         for k, x in g.items()}
            for k, x in g.items():
                grads[k] += x.to(accum_dtype)
            total, loss = total + t, loss + l
            del g
        for x in grads.values():
            x.div_(nm)
        return total / nm, loss / nm, grads

    return grad_fn


def make_train_step(cfg, opt_cfg: optim.AdamWConfig = optim.AdamWConfig(),
                    impl="chunked", microbatches=None,
                    accum_dtype=torch.float32):
    """``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics (``loss``, ``total_loss``,
    ``grad_norm``, ``lr``) are 0-d tensors on the state's device (no host
    sync).  ``accum_dtype=torch.bfloat16`` halves the accumulation
    buffer at ``microbatches > 1``."""
    grad_fn = make_grad_fn(cfg, impl, microbatches, accum_dtype)

    def train_step(state, batch):
        params = state["params"]
        total, loss, grads = grad_fn(params, batch)
        _, opt_state, om = optim.apply(
            opt_cfg, dict(params.named_parameters()), grads, state["opt"])
        del grads
        state["opt"] = opt_state
        return state, {"loss": loss, "total_loss": total, **om}

    return train_step


def make_prefill_step(cfg, impl="chunked"):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = T.forward(params, cfg, batch["tokens"], impl=impl,
                              **_model_inputs(batch))
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg):
    @torch.no_grad()
    def decode_step(params, tokens, pos, caches):
        return T.decode_step(params, cfg, tokens, pos, caches)

    return decode_step


def init_train_state(cfg, generator=None, device=None):
    """``{"params": model, "opt": OptState}``: ``transformer.init``'s
    weights from ``generator`` (default: seed 0) on ``device`` (default:
    the card), made trainable."""
    generator = generator or torch.Generator().manual_seed(0)
    params = T.init(generator, cfg, device)
    params.requires_grad_(True)
    return {"params": params,
            "opt": optim.init(dict(params.named_parameters()))}
