"""Causal attention: GQA/MQA, RoPE / M-RoPE or none (NoPE), global +
sliding-window, scores scaled by 1/sqrt(head_dim) or the configured
``attention_multiplier``, with a
naive path (tests), two chunked paths (long prefill without an S×S
buffer), the hand-written flash-attention kernel, and a ring-buffer
KV-cache decode step (the hand-written decode-attention kernel on a card).

``constrain(x, name)`` is the sharding hook of the distributed layer
(``distributed.sharding.ShardingRules.constrain``), called where the JAX
package calls it: ``"heads"`` on q and the head-expanded k/v of the plain
paths, ``"heads_decode"`` in decode; ``set_score_constrain`` installs the
``"attn_scores"`` hook on the score tensors.  Both default to the
identity, so an unsharded model computes exactly what it did without
them.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import (Params, apply_mrope, apply_rope,
                                       dense_init, dtype_of, no_constrain,
                                       settled)

NEG_INF = -2.0e38
IMPLS = ("naive", "chunked", "chunked_tri", "kernel")


def init(generator, cfg, device):
    d, h, k = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(generator, (d, h, hd), dt, device),
        "wk": dense_init(generator, (d, k, hd), dt, device),
        "wv": dense_init(generator, (d, k, hd), dt, device),
        "wo": dense_init(generator, (h, hd, d), dt, device,
                         in_axis_size=h * hd),
    }
    if cfg.attn_qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((k, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((k, hd), dtype=dt, device=device)
    return Params(**p)


def _rope(cfg, x, positions):
    if cfg.position_embedding == "nope":
        return x
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def _scale(cfg):
    """The score scale: the configuration's ``attention_multiplier``
    where it sets one, else 1/sqrt(head_dim)."""
    return cfg.attention_multiplier or 1.0 / math.sqrt(cfg.resolved_head_dim)


def _project_qkv(params, cfg, x, positions):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,K,hd), RoPE applied (none
    where the configuration's ``position_embedding`` is "nope").  On a
    mesh each comes out settled with its sequence whole (Megatron's
    sequence-parallel gather before attention): DTensor's score products
    fail on a sequence-sharded operand."""
    q, k, v = (settled(torch.einsum("bsd,dhk->bshk", x, w), whole=(1,))
               for w in (params.wq, params.wk, params.wv))
    if cfg.attn_qkv_bias:
        q = q + params.bq
        k = k + params.bk
        v = v + params.bv
    return _rope(cfg, q, positions), _rope(cfg, k, positions), v


# module-level score-sharding hook, set by the distributed layer for archs
# whose head count doesn't divide the model axis (musicgen 24H): sharding
# the key axis of the scores splits the otherwise-replicated attention
# compute (context parallelism).  Default: identity.
_SCORE_CONSTRAIN = [no_constrain]


def set_score_constrain(fn):
    _SCORE_CONSTRAIN[0] = fn or no_constrain


def _sdpa(q, k, v, mask, scale):
    """q (B,S,H,hd), k/v (B,T,H,hd) (kv already head-expanded), mask
    broadcastable to (B,1,S,T).  Scores in float32, softmax, probabilities
    back in q's dtype.

    On a mesh whose q, k and v share one layout that splits the batch
    or the heads and nothing else, every (batch, head) pair is whole on
    one rank: each rank attends its own shards, as GSPMD would (DTensor's
    score products flatten (batch, heads), which torch 2.11's DTensor
    refuses when both are sharded, and crawl on a three-axis mesh)."""
    if _heads_local(q, k, v):
        out = _sdpa(q.to_local(), k.to_local(), v.to_local(), mask, scale)
        return DTensor.from_local(out, q.device_mesh, q.placements)
    scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    scores = _SCORE_CONSTRAIN[0](scores, "attn_scores")
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _heads_local(q, k, v):
    """q, k and v are DTensors of one layout that shards the batch or
    the heads and nothing else, and no score hook is set (a hook's
    layout splits the key axis, which needs the scores on the mesh)."""
    if not isinstance(q, DTensor) or _SCORE_CONSTRAIN[0] is not no_constrain:
        return False
    p = q.placements
    return (all(isinstance(t, DTensor) and t.placements == p
                for t in (k, v))
            and any(x in (Shard(0), Shard(2)) for x in p)
            and all(x in (Replicate(), Shard(0), Shard(2)) for x in p))


def _expand_kv(k, n_heads):
    """(B,T,K,hd) -> (B,T,H,hd) by repeating each kv head H//K times."""
    reps = n_heads // k.shape[2]
    return k.repeat_interleave(reps, dim=2) if reps > 1 else k


def _attend(q, k, v, window, scale, impl, q_chunk, constrain=no_constrain):
    b, s, h, hd = q.shape
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                      scale=scale)
    if impl == "naive" or s <= q_chunk:
        qpos = torch.arange(s, device=q.device)[:, None]
        kpos = torch.arange(s, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        kf = constrain(_expand_kv(k, h), "heads")
        vf = constrain(_expand_kv(v, h), "heads")
        return _sdpa(constrain(q, "heads"), kf, vf, mask[None, None], scale)
    if impl == "chunked":
        return _chunked_forward(q, k, v, window, scale, q_chunk, constrain)
    if impl == "chunked_tri":
        return _chunked_tri_forward(q, k, v, window, scale, q_chunk,
                                    constrain)
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _chunked_tri_forward(q, k, v, window, scale, q_chunk,
                         constrain=no_constrain):
    """Triangular chunked attention: a loop over query chunks with key
    slices k[:, :(i+1)·qc], so the causal upper triangle is never
    computed."""
    b, s, h, hd = q.shape
    qc = min(q_chunk, s)
    if s % qc:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qc}")
    k = constrain(_expand_kv(k, h), "heads")
    v = constrain(_expand_kv(v, h), "heads")
    q = constrain(q, "heads")
    outs = []
    for i in range(s // qc):
        hi = (i + 1) * qc
        s0 = max(0, hi - min(s, window + qc)) if window else 0
        qpos = i * qc + torch.arange(qc, device=q.device)[:, None]
        kpos = s0 + torch.arange(hi - s0, device=q.device)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        outs.append(_sdpa(q[:, i * qc:hi], k[:, s0:hi], v[:, s0:hi],
                          mask[None, None], scale))
    return torch.cat(outs, dim=1)


def _chunked_forward(q, k, v, window, scale, q_chunk, constrain=no_constrain):
    """Loop over query chunks.  Local attention slices a (window + qc) key
    band so compute is O(S·W); global attention scores each chunk against
    the full key range and masks."""
    b, s, h, hd = q.shape
    qc = min(q_chunk, s)
    if s % qc:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {qc}")
    k = constrain(_expand_kv(k, h), "heads")
    v = constrain(_expand_kv(v, h), "heads")
    q = constrain(q, "heads")
    band = s if not window else min(s, window + qc)
    outs = []
    for i in range(s // qc):
        q0 = i * qc
        qpos = q0 + torch.arange(qc, device=q.device)[:, None]
        if window:
            s0 = min(max(q0 + qc - band, 0), s - band)
            k_i, v_i = k[:, s0:s0 + band], v[:, s0:s0 + band]
            kpos = s0 + torch.arange(band, device=q.device)[None, :]
            mask = (kpos <= qpos) & (kpos > qpos - window)
        else:
            k_i, v_i = k, v
            mask = torch.arange(s, device=q.device)[None, :] <= qpos
        outs.append(_sdpa(q[:, q0:q0 + qc], k_i, v_i, mask[None, None], scale))
    return torch.cat(outs, dim=1)


def forward(params, cfg, x, positions, mixer="attn", impl="kernel",
            q_chunk=1024, constrain=no_constrain):
    """Full-sequence causal attention (training / prefill).

    mixer: "attn" (global) or "local" (sliding window of cfg.window).
    impl:  "naive" (S×S scores — small inputs / tests)
           "chunked" / "chunked_tri" (loops over query chunks)
           "kernel" (the default: the hand-written flash-attention kernel
           on a CUDA tensor, its plain version on a CPU one; JAX's
           "pallas")
    """
    y, _, _ = _forward_kv(params, cfg, x, positions, mixer, impl, q_chunk,
                          constrain)
    return y


def _forward_kv(params, cfg, x, positions, mixer, impl, q_chunk, constrain):
    scale = _scale(cfg)
    q, k, v = _project_qkv(params, cfg, x, positions)
    window = cfg.window if mixer == "local" else 0
    out = _attend(q, k, v, window, scale, impl, q_chunk, constrain)
    return _out_proj(params, out), k, v


def _out_proj(params, out):
    """(B,S,H,hd) -> (B,S,D).  On a mesh head_dim is gathered first: the
    product flattens (H, hd), and DTensor (torch 2.11's) flattens only a
    leading sharded dim."""
    return torch.einsum("bshk,hkd->bsd", settled(out, whole=(3,)),
                        params.wo)


def prefill(params, cfg, x, positions, max_seq, mixer="attn", impl="kernel",
            q_chunk=1024, constrain=no_constrain):
    """Forward + ring-buffer cache capture for subsequent decode."""
    b, s, _ = x.shape
    y, k, v = _forward_kv(params, cfg, x, positions, mixer, impl, q_chunk,
                          constrain)
    size = min(max_seq, cfg.window) if mixer == "local" else max_seq
    n_keep = min(s, size)
    p0 = s - n_keep + torch.arange(n_keep, device=x.device)  # kept positions
    slots = p0 % size
    cache = init_cache(cfg, b, max_seq, mixer=mixer, dtype=k.dtype,
                       device=x.device)
    cache["k"][:, slots] = k[:, -n_keep:]
    cache["v"][:, slots] = v[:, -n_keep:]
    cache["pos"][slots] = p0
    return y, cache


# --------------------------------------------------------------------------- #
# decode with ring-buffer KV cache
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch, max_seq, mixer="attn", dtype=None, *, device):
    """Ring-buffer cache. Local mixers only keep ``window`` keys."""
    dt = dtype or dtype_of(cfg)
    size = min(max_seq, cfg.window) if mixer == "local" else max_seq
    kd, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, size, kd, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, size, kd, hd), dtype=dt, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int64, device=device),
    }


def _decode_kernel(q, cache):
    """Whether decode attends through the hand-written kernel: on a card,
    off a mesh (a DTensor keeps the plain path: the mesh's dry run) and
    with no score hook set (its layout needs the scores on the mesh)."""
    return (q.device.type == "cuda"
            and not isinstance(q, DTensor)
            and not isinstance(cache["k"], DTensor)
            and _SCORE_CONSTRAIN[0] is no_constrain)


def decode_step(params, cfg, x, pos, cache, mixer="attn",
                constrain=no_constrain):
    """x (B,1,D); pos: the token's absolute position, a 0-d int64 tensor
    on x's device (an int is taken too).  Returns (y, cache); the cache is
    updated in place (the decode loop owns it).  Off a mesh nothing here
    reads the position on the host: its rotary positions, its ring slot
    and the mask of valid keys are tensors computed from it (on a card
    by the decode-attention kernel, which reads the cache's ``pos`` ring
    and ``pos`` by pointer), so that a CUDA graph that captured the step
    replays it at whatever position ``pos`` holds.  Off the card, on a
    mesh or with a score hook set (``_decode_kernel``), the attention is
    the plain path that ``kernels.decode_attention.ref`` repeats: the
    cache repeated across each group, then ``_sdpa``."""
    b = x.shape[0]
    scale = _scale(cfg)
    # DTensor keeps no sequence-sharded layout through an indexed in-place
    # write: a step on a mesh (never captured) writes at a host slot
    host = int(pos) if isinstance(cache["k"], DTensor) else None
    pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    shape = (b, 3, 1) if cfg.mrope_sections is not None else (b, 1)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos.expand(shape))

    size = cache["k"].shape[1]
    if host is None:
        slot = (pos % size).view(1)
        cache["k"].index_copy_(1, slot, k_new)
        cache["v"].index_copy_(1, slot, v_new)
        cache["pos"].index_copy_(0, slot, pos.view(1))
    else:
        cache["k"][:, host % size] = k_new[:, 0]
        cache["v"][:, host % size] = v_new[:, 0]
        cache["pos"][host % size] = host

    window = cfg.window if mixer == "local" else 0
    if _decode_kernel(q, cache):
        out = da_ops.decode_attention(q, cache, pos, window=window,
                                      scale=scale)
        return _out_proj(params, out), cache
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    if window:
        valid &= cpos > pos - window
    kf = constrain(_expand_kv(cache["k"], cfg.n_heads), "heads_decode")
    vf = constrain(_expand_kv(cache["v"], cfg.n_heads), "heads_decode")
    out = _sdpa(constrain(q, "heads_decode"), kf, vf,
                valid[None, None, None, :], scale)
    return _out_proj(params, out), cache
