"""Mamba-2 block: in_proj -> causal depthwise conv -> SSD -> gated norm ->
out_proj.

Full sequences run the SSD scan through ``kernels.ssd``: ``impl="kernel"``
takes ``ops.ssd`` (the hand-written kernel on a CUDA tensor, its plain
chunked version on a CPU one); any other ``impl`` takes the plain
``ref.ssd_chunked``, as everything but ``"pallas"`` takes the plain
reference in the JAX package.  ``forward`` needs L to be a multiple of
``min(ssd_chunk, L)``, as the JAX forward does; ``prefill`` takes any L
(the chunked scan masks a ragged last chunk).  Decode is one recurrent
step (``ref.ssd_decode_step_``, the cache updated in place).  SSD math
in float32; y rounds to the activations' dtype before the gate.

The conv with its SiLU and the gated norm go through
``kernels.ssm_mixer.ops``, whose ``use_kernels`` is the rule: under
``impl="kernel"`` on plain CUDA tensors, the hand-written one-pass
kernels, which keep float32 from load to store; everywhere else (the
CPU, meta tensors in the dry run, DTensors on a mesh, training's other
impls) the plain ops of ``kernels.ssm_mixer.ref``.  The decode step takes
no ``impl``, as attention's decode does: its gated norm is the kernel's
on the card; its conv stays plain.

Each full-sequence call (``forward``, ``prefill``) is an ``ssm`` span
(``telemetry.spans``) with ``rows``, ``tokens``, ``heads`` and
``mixer_launches``, the mixer kernels' launches in it
(``kernels.ssm_mixer.kernel.launches``: 2 a call on the card, 0 on the
plain path); the decode step opens none.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssm_mixer import kernel as mixer_kernel
from repro_torch.kernels.ssm_mixer import ops as mixer_ops
from repro_torch.models.common import (Params, batch_local, dense_init,
                                       dtype_of, settled, sub_generator)
from repro_torch.telemetry import spans


def _dims(cfg):
    di = cfg.d_inner
    n = cfg.d_state
    h = cfg.n_ssd_heads
    d_conv = di + 2 * n  # conv runs over [x, B, C]
    return di, n, h, d_conv


def init(generator, cfg, device):
    d = cfg.d_model
    di, n, h, d_conv = _dims(cfg)
    dt = dtype_of(cfg)
    f32 = torch.float32
    in_proj = dense_init(generator, (d, 2 * di + 2 * n + h), dt, device)
    conv_w = dense_init(generator, (cfg.conv_width, d_conv), dt, device,
                        in_axis_size=cfg.conv_width)
    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] log-uniformly
    # (the Mamba-2 default), stored as its inverse softplus
    u = torch.empty(h, dtype=f32, device=device).uniform_(
        generator=sub_generator(generator, device))
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return Params(
        in_proj=in_proj,
        conv_w=conv_w,
        conv_b=torch.zeros((d_conv,), dtype=dt, device=device),
        A_log=torch.log(torch.arange(1, h + 1, dtype=f32, device=device)),
        dt_bias=dt_bias,
        D=torch.ones((h,), dtype=f32, device=device),
        norm_w=torch.ones((di,), dtype=dt, device=device),
        out_proj=dense_init(generator, (di, d), dt, device, in_axis_size=di),
    )


def _split(cfg, zxbcdt):
    di, n, _, _ = _dims(cfg)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _scan_inputs(params, cfg, x, impl):
    """in_proj, conv and the SSD operands of a full sequence x (B,L,d):
    (z, xbc before the conv, xs (B,L,H,P), B, C, dt (B,L,H) float32, A)."""
    b, l, _ = x.shape
    di, n, h, _ = _dims(cfg)
    # settled on a mesh: the product over a model-sharded d_model is a
    # partial sum, which DTensor's pad (the conv's shifts) cannot take
    z, xbc_raw, dt_raw = _split(cfg, settled(x @ params.in_proj))
    # the conv reads the in_proj output's slice in place
    xbc = mixer_ops.causal_conv_silu(xbc_raw, params.conv_w, params.conv_b,
                                     impl)
    xs = xbc[..., :di].reshape(b, l, h, cfg.ssd_head_dim)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    return z, xbc_raw, xs, B, C, dt, A


def _scan(params, cfg, xs, dt, A, B, C, impl):
    chunk = min(cfg.ssd_chunk, xs.shape[1])
    if impl == "kernel":
        return ssd_ops.ssd(xs, dt, A, B, C, params.D, chunk=chunk)
    scan = lambda *a: ssd_ref.ssd_chunked(*a, chunk=chunk)
    # on a mesh each rank scans its own batch rows
    out = batch_local(scan, xs, dt, A, B, C, params.D)
    return scan(xs, dt, A, B, C, params.D) if out is None else out


def _out(params, cfg, y, z, impl):
    """Gated rms norm and out_proj of the scan's y (B,L,H,P)."""
    b, l = y.shape[:2]
    y = y.reshape(b, l, cfg.d_inner)
    y = mixer_ops.gated_rms_norm(y, z, params.norm_w, cfg.norm_eps, impl)
    return y @ params.out_proj


def check_whole_chunks(cfg, l):
    """Refuse a sequence of length ``l`` that is not a whole number of SSD
    chunks: ``forward`` needs it, ``prefill`` takes any length."""
    chunk = min(cfg.ssd_chunk, l)
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"SSD chunk {chunk}; prefill takes any length")


@contextlib.contextmanager
def _span(cfg, x):
    """The ``ssm`` span of a full-sequence call on x (B,L,d), its
    ``mixer_launches`` set at the close."""
    b, l = x.shape[:2]
    n0 = mixer_kernel.launches
    with spans.span("ssm", rows=b, tokens=b * l,
                    heads=cfg.n_ssd_heads) as span:
        yield
        span.set(mixer_launches=mixer_kernel.launches - n0)


def forward(params, cfg, x, impl="kernel"):
    """Full-sequence SSD mixer. x (B,L,d) -> y (B,L,d)."""
    check_whole_chunks(cfg, x.shape[1])
    with _span(cfg, x):
        z, _, xs, B, C, dt, A = _scan_inputs(params, cfg, x, impl)
        y, _ = _scan(params, cfg, xs, dt, A, B, C, impl)
        y = _out(params, cfg, y, z, impl)
    return y


def prefill(params, cfg, x, impl="kernel"):
    """Forward + cache capture (SSD state + conv history), any length."""
    with _span(cfg, x):
        z, xbc_raw, xs, B, C, dt, A = _scan_inputs(params, cfg, x, impl)
        y, state = _scan(params, cfg, xs, dt, A, B, C, impl)
        y = _out(params, cfg, y, z, impl)
    w = cfg.conv_width - 1
    l = x.shape[1]
    # a copy, not a view: a view would keep the whole in_proj output of
    # every layer alive for the decode
    hist = xbc_raw[:, -w:, :].contiguous() if l >= w else \
        F.pad(xbc_raw, (0, 0, w - l, 0))
    return y, {"conv": hist, "state": state}


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_cache(cfg, batch, dtype=None, *, device):
    di, n, h, d_conv = _dims(cfg)
    dt = dtype or dtype_of(cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_conv), dtype=dt,
                            device=device),
        "state": torch.zeros((batch, h, cfg.ssd_head_dim, n),
                             dtype=torch.float32, device=device),
    }


def decode_step(params, cfg, x, cache):
    """x (B,1,d) -> (y (B,1,d), cache).  The cache's ``conv`` and
    ``state`` are updated in place and come back as the same tensors, so
    that a step captured in a CUDA graph reads and writes the same memory
    on every replay."""
    b = x.shape[0]
    di, n, h, _ = _dims(cfg)
    z, xbc, dt_raw = _split(cfg, x @ params.in_proj)        # (B,1,...)
    # conv over [stored history, current]
    hist = torch.cat([cache["conv"], xbc], dim=1)          # (B,W,Dc)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", hist, params.conv_w)
                      + params.conv_b)
    xs = conv_out[:, :di].reshape(b, h, cfg.ssd_head_dim)
    B = conv_out[:, di:di + n]
    C = conv_out[:, di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    y = ssd_ref.ssd_decode_step_(xs, dt, A, B, C, params.D, cache["state"])
    cache["conv"].copy_(hist[:, 1:, :])
    # decode takes no impl (as attention's decode kernel): the gate
    # kernel wherever the tensors are plain CUDA ones
    return _out(params, cfg, y[:, None], z, "kernel"), cache
