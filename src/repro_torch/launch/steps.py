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
for JAX's donated buffers.  ``constrain`` is the distributed layer's
sharding hook: with a state placed by ``ShardingRules.distribute_state``
and a batch by ``batch_spec`` the same step runs on DTensors.

``input_specs``, ``abstract_params`` and ``abstract_train_state`` are the
dry run's stand-ins: ``meta`` tensors of JAX's shapes and dtypes, with no
storage and no random fill.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import dtype_of, no_constrain
from repro_torch.training import losses, optim

META = torch.device("meta")

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


def input_specs(cfg, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of ``shape_name``, with
    JAX's shapes and dtypes (int32 tokens); decode's ``caches`` are
    ``transformer.init_caches``' per-layer dicts on ``meta``."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]

    def sds(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device=META)

    if info["kind"] in ("train", "prefill"):
        specs = {}
        s_text = s
        if cfg.vision_tokens:
            s_text = s - cfg.vision_tokens
            specs["vision_embeds"] = sds((b, cfg.vision_tokens, cfg.d_model),
                                         dtype_of(cfg))
            specs["positions"] = sds((b, 3, s))
        if cfg.n_codebooks > 1:
            specs["tokens"] = sds((b, cfg.n_codebooks, s_text))
        else:
            specs["tokens"] = sds((b, s_text))
        if info["kind"] == "train":
            if cfg.n_codebooks > 1:
                specs["labels"] = sds((b, cfg.n_codebooks, s_text))
            else:
                specs["labels"] = sds((b, s))  # includes vision positions
        return specs

    # decode: one token against a cache of length `seq`; the attention
    # caches' position rings in JAX's int32 (the port's own are int64)
    caches = T.init_caches(cfg, b, s, device=META)
    for c in caches:
        if "pos" in c:
            c["pos"] = sds(c["pos"].shape)
    return {
        "tokens": sds((b, cfg.n_codebooks) if cfg.n_codebooks > 1 else (b,)),
        "pos": sds(()),
        "caches": caches,
    }


def make_grad_fn(cfg, impl="chunked", microbatches=None,
                 accum_dtype=torch.float32, constrain=no_constrain):
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
                                remat=True, constrain=constrain,
                                **_model_inputs(batch))
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
                grads = {k: torch.zeros_like(x, dtype=accum_dtype)
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
                    accum_dtype=torch.float32, constrain=no_constrain):
    """``train_step(state, batch) -> (state, metrics)``: the state is
    updated in place and returned; metrics (``loss``, ``total_loss``,
    ``grad_norm``, ``lr``) are 0-d tensors on the state's device (no host
    sync).  ``accum_dtype=torch.bfloat16`` halves the accumulation
    buffer at ``microbatches > 1``."""
    grad_fn = make_grad_fn(cfg, impl, microbatches, accum_dtype, constrain)

    def train_step(state, batch):
        params = state["params"]
        total, loss, grads = grad_fn(params, batch)
        _, opt_state, om = optim.apply(
            opt_cfg, dict(params.named_parameters()), grads, state["opt"])
        del grads
        state["opt"] = opt_state
        return state, {"loss": loss, "total_loss": total, **om}

    return train_step


def make_prefill_step(cfg, impl="chunked", constrain=no_constrain):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = T.forward(params, cfg, batch["tokens"], impl=impl,
                              constrain=constrain, **_model_inputs(batch))
        return logits[:, -1]

    return prefill_step


def make_decode_step(cfg, constrain=no_constrain):
    @torch.no_grad()
    def decode_step(params, tokens, pos, caches):
        return T.decode_step(params, cfg, tokens, pos, caches,
                             constrain=constrain)

    return decode_step


def init_train_state(cfg, generator=None, device=None, rules=None):
    """``{"params": model, "opt": OptState}``: ``transformer.init``'s
    weights from ``generator`` (default: seed 0) on ``device`` (default:
    the card), made trainable.  With ``rules`` (a ``ShardingRules`` on a
    mesh) the weights are placed by them as soon as they are made and
    the moments are made sharded, so no rank holds the whole optimiser
    state."""
    generator = generator or torch.Generator().manual_seed(0)
    params = T.init(generator, cfg, device)
    params.requires_grad_(True)
    if rules is not None:
        rules.distribute(params)
    return {"params": params,
            "opt": optim.init(dict(params.named_parameters()))}


def abstract_params(cfg):
    """The model's ``Params`` on ``meta``: every shape and dtype, no
    storage, no random fill."""
    return T.init(torch.Generator(), cfg, META)


def abstract_train_state(cfg):
    """``init_train_state`` on ``meta``: the parameters (trainable) and
    the zero ``OptState``, shapes and dtypes only."""
    return init_train_state(cfg, torch.Generator(), META)
