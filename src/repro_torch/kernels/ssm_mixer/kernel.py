"""Wrappers of the hand-written CUDA kernels of the Mamba-2 mixer's two
elementwise passes (csrc/ssm_mixer.cu), which replace no TPU kernel: the
JAX package's block (src/repro/models/ssm.py, ``_causal_conv`` and
``_out``) is plain jnp.

``causal_conv_silu(x, w, b)``: x (B, L, C) with its channels contiguous,
read in place at its batch and row strides (the in_proj output's conv
slice); w (W, C) and b (C,) contiguous, W ``CONV_WIDTH``.  Returns
silu(the causal depthwise conv + b), a contiguous (B, L, C); each batch
row's first W - 1 positions see zeros before it.

``gated_rms_norm(y, z, w, eps)``: y and z (B, L, C) with their channels
contiguous, each at its own batch and row strides; w (C,) contiguous.
Returns g · rsqrt(mean(g²) + eps) · w for g = y · silu(z), a contiguous
(B, L, C).

Both take CUDA tensors of one dtype, bfloat16 or float32, keep float32
from load to store and round once; anything else raises (``ops`` decides
where the kernels run and sends everything else to ``ref``).  Inputs that require grad
raise (the kernels have no backward; ``_build.refuse_grad``).  Each
thread moves VEC channels at a time, the widest vector of at most 16
bytes that every pointer, stride and C are multiples of
(``vector_width``): 8 bf16 channels at mamba2-780m's and
granite-4.0-h-small's layouts, narrower where a small model's asks for
it.  A gated-norm row may take up to ``PERS[-1]`` vectors a thread of
``GATE_THREADS``: 8192 bf16 channels in vectors of 8, 4096 float32 ones
in vectors of 4; a wider row raises.

``launches`` counts calls of either kernel that launched (a call made
while its stream is captured into a CUDA graph launches nothing and is
not counted; a replay is not counted either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CONV_WIDTH = 4                    # the conv kernel's W (kConvWidth)
GATE_THREADS = 512                # most threads of a gate block ...
PERS = (1, 2)                     # ... before each holds more vectors

launches = 0


def vector_width(esize, *sizes):
    """The widest vector (a power of two of ``esize``-byte elements, 16
    bytes at most) that divides every byte size or address of
    ``sizes``."""
    vec = 16 // esize
    while vec > 1 and any(s % (vec * esize) for s in sizes):
        vec //= 2
    return vec


def _check_types(what, *tensors):
    """Tensors of one dtype in ``DTYPES``, on one CUDA device (checked
    after the shapes and strides, so that those faults show on any
    device)."""
    first = tensors[0]
    for name, t in zip(what, tensors):
        if t.dtype not in DTYPES:
            raise ValueError(f"{name} has dtype {t.dtype}; the kernel takes "
                             f"one of {list(DTYPES)}")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name} has dtype {t.dtype} on {t.device}, "
                             f"expected {first.dtype} on {first.device}")
    if first.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got "
                         f"{first.device}")


def _rows(name, t, c):
    """The (batch, row) strides of a (B, L, C) view whose channels are
    contiguous, and its bytes that a vector must divide."""
    if t.dim() != 3 or t.shape[2] != c:
        raise ValueError(f"{name} must be (B, L, {c}), got {tuple(t.shape)}")
    if t.stride(2) != 1 and c > 1:
        raise ValueError(f"{name}'s channels are not contiguous (strides "
                         f"{t.stride()})")
    size = t.element_size()
    return (t.stride(0), t.stride(1)), [t.data_ptr()] + [
        t.stride(i) * size for i in range(2) if t.shape[i] > 1]


def _contiguous(name, t, shape):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return [t.data_ptr()]


def causal_conv_silu(x, w, b):
    _build.refuse_grad("causal_conv_silu", "the model's plain conv "
                       "(impl='chunked' or 'naive')", x, w, b)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"x must be (B, L, C) and w (W, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    bt, l, c = x.shape
    width = w.shape[0]
    if width != CONV_WIDTH:
        raise ValueError(f"conv width {width} is not the kernel's "
                         f"{CONV_WIDTH}")
    (sb, sl), sizes = _rows("x", x, c)
    sizes += _contiguous("w", w, (width, c)) + _contiguous("b", b, (c,))
    _check_types(("x", "w", "b"), x, w, b)
    esize = x.element_size()
    out = torch.empty((bt, l, c), dtype=x.dtype, device=x.device)
    vec = vector_width(esize, c * esize, out.data_ptr(), *sizes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _build.library().ssm_conv_silu_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), bt, l, c,
        sb, sl, vec, DTYPES[x.dtype], stream)
    _build.check(status, "ssm_conv_silu_launch")
    _count()
    return out


def gate_layout(c, vec):
    """``(vectors a thread holds, threads a block)`` of a gated-norm row
    of ``c`` channels moved ``vec`` at a time: the fewest vectors a thread
    that keep a block at ``GATE_THREADS`` or under, whole warps."""
    groups = c // vec
    for per in PERS:
        threads = -(-groups // per)
        if threads <= GATE_THREADS:
            return per, -(-threads // 32) * 32
    raise ValueError(f"{c} channels in vectors of {vec} need more than "
                     f"{PERS[-1]} vectors a thread")


def gated_rms_norm(y, z, w, eps):
    _build.refuse_grad("gated_rms_norm", "the model's plain gated norm "
                       "(impl='chunked' or 'naive')", y, z, w)
    if y.dim() != 3:
        raise ValueError(f"y must be (B, L, C), got {tuple(y.shape)}")
    bt, l, c = y.shape
    if tuple(z.shape) != (bt, l, c):
        raise ValueError(f"z has shape {tuple(z.shape)}, expected "
                         f"{(bt, l, c)}")
    (y_sb, y_sl), sizes = _rows("y", y, c)
    (z_sb, z_sl), z_sizes = _rows("z", z, c)
    sizes += z_sizes + _contiguous("w", w, (c,))
    _check_types(("y", "z", "w"), y, z, w)
    esize = y.element_size()
    out = torch.empty((bt, l, c), dtype=y.dtype, device=y.device)
    vec = vector_width(esize, c * esize, out.data_ptr(), *sizes)
    per, threads = gate_layout(c, vec)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    status = _build.library().ssm_gated_norm_launch(
        y.data_ptr(), z.data_ptr(), w.data_ptr(), out.data_ptr(), bt, l, c,
        y_sb, y_sl, z_sb, z_sl, float(eps), vec, per, threads,
        DTYPES[y.dtype], stream)
    _build.check(status, "ssm_gated_norm_launch")
    _count()
    return out


def _count():
    global launches
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
