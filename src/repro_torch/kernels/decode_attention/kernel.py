"""Wrapper of the hand-written CUDA decode-attention kernel
(csrc/decode_attention.cu), which replaces no TPU kernel: the JAX
package's decode step (src/repro/models/attention.py:248) is plain jnp.

``decode_attention(q, k, v, slot_pos, pos, *, window=0, scale=None)``: one
query token a row against a ring-buffer KV cache.  q (B, 1, H, D); k/v
(B, T, K, D) with H % K == 0, q head ``h`` reading kv head
``h // (H // K)`` in place (never repeated); ``slot_pos`` (T,) int64, the
position each ring slot holds (-1 where none); ``pos`` the query's
position, a 0-d int64 tensor on the same device.  The keys are the slots
with ``0 <= slot_pos <= pos`` and, given a ``window``, ``slot_pos > pos -
window``; the kernel reads both by pointer, so a CUDA graph that captured
the call replays it at whatever position the tensors hold.  Returns a
contiguous (B, 1, H, D) in q's dtype.

It takes CUDA tensors: bfloat16, D in (64, 128, 256), D contiguous and
every other stride and the data pointers 16-byte aligned; anything else
raises (the model's plain decode step serves CPU tensors; its plain
version is ``ref.decode_attention_ref``).  Inputs that require grad raise
(the kernel has no backward; ``_build.refuse_grad``).

The kernel splits each (batch row, KV head)'s keys into ranges of 64-key
tiles, one block a range, and merges the ranges' float32 partials in a
second launch (csrc/decode_attention.cu has the design).  The number of
ranges comes from the shapes and the card: enough blocks for ``WAVES``
per multiprocessor, with at least one tile a range.
``decode_attention.launches`` counts calls that launched (a call made
while its stream is captured into a CUDA graph launches nothing and is
not counted; a replay is not counted either).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)        # the kernel's instantiations
TILE = 64                         # keys a tile (csrc: kTile)
WAVES = 2                         # blocks a multiprocessor, at least
ALIGN = 16                        # bytes: the kernel's 16-byte row copies


def _check(q, k, v, slot_pos, pos):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, D) and k, v (B, T, K, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"{h} q heads do not group onto {kh} kv heads")
    for name, x, shape in (("k", k, (b, t, kh, d)), ("v", v, (b, t, kh, d)),
                           ("slot_pos", slot_pos, (t,)), ("pos", pos, ())):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, expected {q.device}")
    return b, h, kh, t, d


def _check_cuda(q, k, v, slot_pos, pos, d):
    """What the kernel takes beyond the shapes: CUDA tensors, bf16 rows
    of D in (64, 128, 256) at 16-byte aligned strides, int64 positions."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} has dtype {x.dtype}; the kernel takes "
                             f"torch.bfloat16")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head_dim is not contiguous "
                             f"(stride {x.stride(3)})")
        size = x.element_size()
        if x.data_ptr() % ALIGN or any(
                x.stride(i) * size % ALIGN for i in range(3)
                if x.shape[i] > 1):
            raise ValueError(f"{name}'s rows are not {ALIGN}-byte aligned "
                             f"(strides {x.stride()}, pointer "
                             f"{x.data_ptr()})")
    for name, x in (("slot_pos", slot_pos), ("pos", pos)):
        if x.dtype != torch.int64 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous int64, got "
                             f"{x.dtype} at strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _multiprocessors(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits_for(blocks: int, t: int, n_sm: int):
    """``(splits, tiles per split)`` of ``t`` keys for ``blocks`` (batch
    row, KV head, head chunk) triples on ``n_sm`` multiprocessors: the
    fewest ranges that give ``WAVES`` blocks a multiprocessor, at most
    one a tile, each range as long as the others but the last."""
    tiles = -(-t // TILE)
    want = min(tiles, max(1, -(-WAVES * n_sm // blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def decode_attention(q, k, v, slot_pos, pos, *, window=0, scale=None):
    _build.refuse_grad("decode_attention", "the model's plain decode step "
                       "(a CPU model)", q, k, v)
    b, h, kh, t, d = _check(q, k, v, slot_pos, pos)
    _check_cuda(q, k, v, slot_pos, pos, d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    chunks = -(-(h // kh) // 16)
    index = q.device.index
    n_sm = _multiprocessors(torch.cuda.current_device() if index is None
                            else index)
    splits, per = splits_for(b * kh * chunks, t, n_sm)
    return _launch(q, k, v, slot_pos, pos, window, scale, splits, per)


def _launch(q, k, v, slot_pos, pos, window, scale, splits, per):
    """The two launches at a given split of the keys (checked operands)."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    lib = _build.library()
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    q_strides = (ctypes.c_longlong * 2)(q.stride(0), q.stride(2))
    kv_strides = (ctypes.c_longlong * 6)(
        *(x.stride(i) for x in (k, v) for i in range(3)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        pos.data_ptr(), part.data_ptr(), out.data_ptr(), b, h, kh, t, d,
        int(window), splits, per, float(scale), q_strides, kv_strides,
        stream)
    _build.check(status, "decode_attention_launch")
    if not torch.cuda.is_current_stream_capturing():
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
