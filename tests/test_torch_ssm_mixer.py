"""The Mamba-2 mixer's elementwise kernels (``kernels/ssm_mixer``: the
causal conv with its SiLU, the gated RMS norm) and the dispatch in
``models/ssm.py`` that routes to them.

On the CPU: the plain versions (``ref``) are the model's plain ops
bitwise; ``ops`` on CPU tensors is the plain version under every impl
and launches nothing; the wrapper refuses a CPU tensor, a wrong dtype, channels that
are not contiguous, other shapes and inputs that require grad; the
vector width it takes at mamba2-780m's, granite-4.0-h-small's and a tiny
model's layouts, and narrower ones where a stride or a pointer asks; the
gated norm's block layout; ``ssm.forward`` and ``ssm.prefill`` bitwise
unchanged on the CPU, the dispatch's rule (``ops.use_kernels``), and the
kernel wrappers handed the in_proj output's slices in place.

The ``cuda`` cases (run on a card with ``PYTHONPATH=src python -m pytest
--noconftest -m cuda tests/test_torch_ssm_mixer.py``; elsewhere they skip
from inside the ``cuda_device`` fixture) hold both kernels to the plain
version in float32 within one bf16 ulp and no further off than the plain
bf16 path, at a tiny model's, mamba2-780m's and granite's widths and L in
{1, 3, 4, 37, 2048}; the float32 kernels to the float32 plain version;
batch rows independent; a narrow vector equal to the wide one; a whole
``ssm.prefill`` with and without the kernels; and ``mixer_launches`` 2 a
call.  This module imports no JAX."""
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_tiny_config
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssm_mixer import kernel as mk
from repro_torch.kernels.ssm_mixer import ops as mops
from repro_torch.kernels.ssm_mixer import ref as mref
from repro_torch.models import ssm
from repro_torch.models.common import rms_norm, shift_right
from repro_torch.telemetry import spans

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

# (d_inner, d_state, heads): the conv runs over d_inner + 2 d_state
# channels of the in_proj output's rows of 2 d_inner + 2 d_state + heads
WIDTHS = {
    "tiny": (512, 32, 16),
    "mamba2-780m": (3072, 128, 48),
    "granite-4.0-h-small": (8192, 128, 128),
}
LENGTHS = (1, 3, 4, 37, 2048)
# one bf16 ulp of the output (2^-7 of it) plus a small absolute term for
# float32 summation order near zero
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-4


# the model's plain ops before the kernels, as ``models/ssm.py`` ran them
def _old_conv(xbc, w, b):
    wsize = w.shape[0]
    out = xbc * w[-1]
    for i in range(1, wsize):
        shifted = shift_right(xbc, i)
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _old_gate(y, z, w, eps):
    return rms_norm(y * F.silu(z.float()).to(y.dtype), w, eps)


def _inputs(width, b, l, dtype, device="cpu", seed=0):
    """The in_proj output (B, L, 2 di + 2 n + H), conv taps and bias, the
    scan's y (B, L, di) and the norm's weight, at the model's scales."""
    di, n, h = WIDTHS[width]
    dc = di + 2 * n
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=device)
    zxbcdt = rn(b, l, 2 * di + 2 * n + h).to(dtype)
    w = (rn(4, dc) / 2).to(dtype)
    bias = (rn(dc) / 10).to(dtype)
    y = rn(b, l, di).to(dtype)
    norm_w = (1 + rn(di) / 10).to(dtype)
    return zxbcdt, w, bias, y, norm_w


def _slices(zxbcdt, width):
    """z and the conv's input: the in_proj output's slices, in place."""
    di, n, _ = WIDTHS[width]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("l", [1, 3, 4, 37])
def test_ref_is_the_models_plain_ops(l, dtype):
    zxbcdt, w, bias, y, norm_w = _inputs("tiny", 3, l, getattr(torch, dtype))
    z, xbc = _slices(zxbcdt, "tiny")
    assert torch.equal(mref.causal_conv_silu_ref(xbc, w, bias),
                       _old_conv(xbc, w, bias))
    assert torch.equal(mref.gated_rms_norm_ref(y, z, norm_w, 1e-5),
                       _old_gate(y, z, norm_w, 1e-5))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ops_on_the_cpu_is_the_plain_version(dtype):
    zxbcdt, w, bias, y, norm_w = _inputs("tiny", 2, 37, getattr(torch, dtype))
    z, xbc = _slices(zxbcdt, "tiny")
    n = mk.launches
    for impl in ("kernel", "chunked"):
        assert torch.equal(mops.causal_conv_silu(xbc, w, bias, impl),
                           mref.causal_conv_silu_ref(xbc, w, bias))
        assert torch.equal(mops.gated_rms_norm(y, z, norm_w, 1e-6, impl),
                           mref.gated_rms_norm_ref(y, z, norm_w, 1e-6))
    assert mk.launches == n


def test_conv_sees_zeros_before_each_row():
    """The plain conv's first W - 1 positions of a row read zeros, not the
    row before: a row alone equals the row in a batch."""
    zxbcdt, w, bias, _, _ = _inputs("tiny", 3, 5, torch.float32)
    _, xbc = _slices(zxbcdt, "tiny")
    whole = mref.causal_conv_silu_ref(xbc, w, bias)
    for r in range(3):
        assert torch.equal(mref.causal_conv_silu_ref(xbc[r:r + 1], w, bias),
                           whole[r:r + 1])


def test_wrapper_refuses_what_the_kernels_do_not_take():
    zxbcdt, w, bias, y, norm_w = _inputs("tiny", 2, 8, torch.bfloat16)
    z, xbc = _slices(zxbcdt, "tiny")
    f16 = lambda *t: [u.to(torch.float16) for u in t]
    conv_bad = {
        "cpu": (xbc, w, bias),
        "dtype": f16(xbc, w, bias),
        "mixed dtypes": (xbc, w.float(), bias),
        "channels not contiguous": (xbc[..., ::2], w[:, ::2], bias[::2]),
        "taps not contiguous": (xbc, w.t().contiguous().t(), bias),
        "width 3": (xbc, w[:3], bias),
        "bias shape": (xbc, w, bias[:-8]),
    }
    gate_bad = {
        "cpu": (y, z, norm_w),
        "dtype": f16(y, z, norm_w),
        "channels not contiguous": (y[..., ::2], z[..., ::2], norm_w[::2]),
        "z shape": (y, z[:, :-1], norm_w),
        "weight shape": (y, z, norm_w[:-8]),
    }
    n = mk.launches
    for what, args in conv_bad.items():
        with pytest.raises(ValueError,
                           match="CUDA|dtype|contiguous|width|shape"):
            mk.causal_conv_silu(*args)
    for what, args in gate_bad.items():
        with pytest.raises(ValueError, match="CUDA|dtype|contiguous|shape"):
            mk.gated_rms_norm(*args, 1e-5)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.causal_conv_silu(xbc, w.clone().requires_grad_(), bias)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.gated_rms_norm(y.clone().requires_grad_(), z, norm_w, 1e-5)
    assert mk.launches == n


@pytest.mark.parametrize("width", list(WIDTHS))
def test_model_layouts_take_the_widest_vector(width):
    """The conv's input and z are the in_proj output's slices at its row
    stride and channel offsets: 16-byte aligned at every width here, so
    8 bf16 channels a vector (4 float32)."""
    for dtype, vec in ((torch.bfloat16, 8), (torch.float32, 4)):
        zxbcdt, w, bias, y, _ = _inputs(width, 2, 3, dtype)
        z, xbc = _slices(zxbcdt, width)
        es = zxbcdt.element_size()
        assert zxbcdt.data_ptr() % 16 == 0
        for t in (xbc, z):
            (sb, sl), sizes = mk._rows("x", t, t.shape[2])
            assert (sb, sl) == (3 * zxbcdt.shape[2], zxbcdt.shape[2])
            assert mk.vector_width(es, t.shape[2] * es, *sizes) == vec


@pytest.mark.parametrize("row,offset,channels,want", [
    (1104, 512, 576, 8),      # the tiny models' layout
    (1106, 512, 576, 2),      # a row stride of 4-byte multiples
    (1104, 516, 576, 4),      # an offset of 8-byte multiples
    (1104, 513, 576, 1),      # an odd offset
    (1104, 512, 580, 4),      # channels of 8-byte multiples
])
def test_narrower_vectors_where_the_layout_asks(row, offset, channels, want):
    x = torch.zeros(2, 3, row, dtype=torch.bfloat16)
    (_, _), sizes = mk._rows("x", x[..., offset:offset + channels], channels)
    assert mk.vector_width(2, channels * 2, *sizes) == want


@pytest.mark.parametrize("c,vec,want", [
    (3072, 8, (1, 384)),      # mamba2-780m
    (8192, 8, (2, 512)),      # granite-4.0-h-small
    (512, 8, (1, 64)),        # the tiny models
    (512, 1, (1, 512)),
    (576, 2, (1, 288)),
    (2052, 4, (2, 288)),
    (4096, 4, (2, 512)),      # the widest float32 row
    (7, 1, (1, 32)),
])
def test_gate_layout_covers_the_row(c, vec, want):
    per, threads = mk.gate_layout(c, vec)
    assert (per, threads) == want
    assert threads % 32 == 0 and threads <= mk.GATE_THREADS
    assert threads * per * vec >= c > (threads - 32) * per * vec


def test_gate_layout_refuses_a_row_too_wide():
    with pytest.raises(ValueError, match="vectors a thread"):
        mk.gate_layout(mk.GATE_THREADS * mk.PERS[-1] * 8 + 8, 8)
    with pytest.raises(ValueError, match="vectors a thread"):
        mk.gate_layout(8192, 4)    # granite's width in float32


# ------------------------------------------------------------ the model
def _model(name, dtype, device="cpu"):
    cfg = get_tiny_config(name).replace(dtype=dtype)
    params = ssm.init(torch.Generator().manual_seed(0), cfg, device)
    # a bias and a norm weight that are not the init's zeros and ones
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for w, base in ((params.conv_b, 0.0), (params.norm_w, 1.0)):
            w.copy_(base + torch.randn(w.shape, generator=g) / 10)
    return cfg, params


def _old_prefill(params, cfg, x):
    """``ssm.prefill`` as it ran before the kernels: (y, state)."""
    b, l, _ = x.shape
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
    z, xbc_raw, dt_raw = ssm._split(cfg, x @ params.in_proj)
    xbc = _old_conv(xbc_raw, params.conv_w, params.conv_b)
    xs = xbc[..., :di].reshape(b, l, h, cfg.ssd_head_dim)
    dt = F.softplus(dt_raw.float() + params.dt_bias)
    y, state = ssd_ref.ssd_chunked(xs, dt, -torch.exp(params.A_log),
                                   xbc[..., di:di + n], xbc[..., di + n:],
                                   params.D, chunk=min(cfg.ssd_chunk, l))
    y = _old_gate(y.reshape(b, l, di), z, params.norm_w, cfg.norm_eps)
    return y @ params.out_proj, state


@pytest.mark.parametrize("impl", ["kernel", "chunked"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["mamba2-780m", "granite-4.0-h-small"])
def test_forward_and_prefill_on_the_cpu_are_unchanged(name, dtype, impl):
    cfg, params = _model(name, dtype)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 64, cfg.d_model, generator=g).to(params.in_proj.dtype)
    n = mk.launches
    want, want_state = _old_prefill(params, cfg, x)
    assert torch.equal(ssm.forward(params, cfg, x, impl=impl), want)
    for l in (64, 37, 2):
        want, want_state = _old_prefill(params, cfg, x[:, :l])
        got, cache = ssm.prefill(params, cfg, x[:, :l], impl=impl)
        assert torch.equal(got, want)
        assert torch.equal(cache["state"], want_state)
    assert mk.launches == n


def test_dispatch_takes_the_kernels_under_kernel_on_a_card_only():
    cpu = torch.zeros(2, 3)
    meta = torch.zeros(2, 3, device="meta")
    assert not mops.use_kernels("kernel", cpu, cpu)
    assert not mops.use_kernels("kernel", meta)
    for impl in ("chunked", "naive", "chunked_tri"):
        assert not mops.use_kernels(impl, cpu)


@pytest.mark.parametrize("call", ["forward", "prefill"])
def test_the_kernels_see_the_in_proj_output_in_place(call, monkeypatch):
    """With the dispatch forced on the CPU and the kernel wrappers faked
    by the plain versions: each full-sequence call hands the conv kernel
    the in_proj output's conv slice and the gate kernel its z slice, read
    at the projection's row stride (no copy), once each, and takes the
    kernels' result."""
    cfg, params = _model("granite-4.0-h-small", "bfloat16")
    x = torch.randn(2, 64, cfg.d_model,
                    generator=torch.Generator().manual_seed(3)).to(
                        torch.bfloat16)
    want = getattr(ssm, call)(params, cfg, x)
    seen = []

    def recorded(fn, name):
        def run(a, b, c, *rest):
            seen.append((name, a.shape, a.stride(), b.shape, b.stride()))
            return fn(a, b, c, *rest)
        return run

    monkeypatch.setattr(mops, "use_kernels", lambda impl, *t: True)
    monkeypatch.setattr(mk, "causal_conv_silu", recorded(
        mref.causal_conv_silu_ref, "conv"))
    monkeypatch.setattr(mk, "gated_rms_norm", recorded(
        mref.gated_rms_norm_ref, "gate"))
    got = getattr(ssm, call)(params, cfg, x)
    got, want = (got[0], want[0]) if call == "prefill" else (got, want)
    assert torch.equal(got, want)
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
    row = 2 * di + 2 * n + h
    assert seen == [
        ("conv", (2, 64, di + 2 * n), (64 * row, row, 1),
         (cfg.conv_width, di + 2 * n), (di + 2 * n, 1)),
        ("gate", (2, 64, di), (64 * di, di, 1), (2, 64, di),
         (64 * row, row, 1))]


# --------------------------------------------------------------- a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


def _bar(got, plain, want, what):
    """``got`` within one bf16 ulp of the float32 ``want`` everywhere and
    no further off than the plain bf16 path ``plain``."""
    err = (got.float() - want).abs()
    over = err > BF16_ULP_ATOL + BF16_ULP_RTOL * want.abs()
    assert not bool(over.any()), (
        f"{what}: {int(over.sum())} outputs over one bf16 ulp (max abs err "
        f"{float(err.max())})")
    plain_err = float((plain.float() - want).abs().max())
    assert float(err.max()) <= plain_err, (what, float(err.max()), plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("l", LENGTHS)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_kernels_match_float32_plain_version(cuda_device, width, l):
    b = 2 if l == 2048 else 3
    zxbcdt, w, bias, y, norm_w = _inputs(width, b, l, torch.bfloat16,
                                         cuda_device, seed=l)
    z, xbc = _slices(zxbcdt, width)
    f = lambda *t: [u.float() for u in t]
    n = mk.launches
    conv = mk.causal_conv_silu(xbc, w, bias)
    gate = mk.gated_rms_norm(y, z, norm_w, 1e-5)
    torch.cuda.synchronize()
    assert mk.launches == n + 2
    assert conv.is_contiguous() and gate.is_contiguous()
    assert conv.dtype == gate.dtype == torch.bfloat16
    _bar(conv, mref.causal_conv_silu_ref(xbc, w, bias),
         mref.causal_conv_silu_ref(*f(xbc, w, bias)), f"conv {width} L={l}")
    _bar(gate, mref.gated_rms_norm_ref(y, z, norm_w, 1e-5),
         mref.gated_rms_norm_ref(*f(y, z, norm_w), 1e-5),
         f"gate {width} L={l}")


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "mamba2-780m"])
def test_float32_kernels_match_float32_plain_version(cuda_device, width):
    zxbcdt, w, bias, y, norm_w = _inputs(width, 2, 37, torch.float32,
                                         cuda_device)
    z, xbc = _slices(zxbcdt, width)
    for got, want in (
            (mk.causal_conv_silu(xbc, w, bias),
             mref.causal_conv_silu_ref(xbc, w, bias)),
            (mk.gated_rms_norm(y, z, norm_w, 1e-6),
             mref.gated_rms_norm_ref(y, z, norm_w, 1e-6))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(WIDTHS))
def test_batch_rows_are_independent(cuda_device, width):
    zxbcdt, w, bias, y, norm_w = _inputs(width, 4, 37, torch.bfloat16,
                                         cuda_device)
    other = zxbcdt.clone()
    other[2] = torch.randn_like(other[2], dtype=torch.float32).to(
        torch.bfloat16)
    y2 = y.clone()
    y2[2] = -y2[2]
    outs = []
    for zx, yy in ((zxbcdt, y), (other, y2)):
        z, xbc = _slices(zx, width)
        outs.append((mk.causal_conv_silu(xbc, w, bias),
                     mk.gated_rms_norm(yy, z, norm_w, 1e-5)))
    for a, b in zip(*outs):
        keep = [0, 1, 3]
        assert torch.equal(a[keep], b[keep])
        assert not torch.equal(a[2], b[2])


@pytest.mark.cuda
def test_a_narrow_vector_equals_the_wide_one(cuda_device):
    """The same values at an odd channel offset and row stride (one
    element a vector) give the conv's result of the aligned layout
    bitwise, and the gate's within one bf16 ulp (its sum of squares is
    taken in another order)."""
    zxbcdt, w, bias, y, norm_w = _inputs("tiny", 2, 37, torch.bfloat16,
                                         cuda_device)
    z, xbc = _slices(zxbcdt, "tiny")
    odd = torch.zeros(2, 37, zxbcdt.shape[2] + 3, dtype=torch.bfloat16,
                      device=cuda_device)
    odd[..., 1:1 + zxbcdt.shape[2]] = zxbcdt
    oz, oxbc = _slices(odd[..., 1:1 + zxbcdt.shape[2]], "tiny")
    (_, _), sizes = mk._rows("x", oxbc, oxbc.shape[2])
    assert mk.vector_width(2, oxbc.shape[2] * 2, *sizes) == 1
    assert torch.equal(mk.causal_conv_silu(oxbc, w, bias),
                       mk.causal_conv_silu(xbc, w, bias))
    narrow = mk.gated_rms_norm(y, oz, norm_w, 1e-5).float()
    wide = mk.gated_rms_norm(y, z, norm_w, 1e-5).float()
    assert bool(((narrow - wide).abs() <= BF16_ULP_RTOL * wide.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("l", [4, 37, 256])
@pytest.mark.parametrize("name", ["mamba2-780m", "granite-4.0-h-small"])
def test_prefill_with_and_without_the_kernels(cuda_device, name, l,
                                              monkeypatch):
    """A whole ``ssm.prefill`` in bf16 with the kernels against the same
    call in float32 (the plain path, weights and input cast up): no
    further off than the bf16 plain path, in the largest and the mean
    error; the conv history bitwise the plain path's; the state close."""
    cfg, params = _model(name, "bfloat16", cuda_device)
    x = torch.randn(3, l, cfg.d_model, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(l)
                    ).to(torch.bfloat16)
    n = mk.launches
    with spans.enable():
        spans.clear()
        got, cache = ssm.prefill(params, cfg, x)
        (span,) = [s for s in spans.finished() if s.name == "ssm"]
        spans.clear()
    assert span.fields["mixer_launches"] == 2 and mk.launches == n + 2
    monkeypatch.setattr(mops, "use_kernels", lambda impl, *t: False)
    plain, plain_cache = ssm.prefill(params, cfg, x)
    cfg32 = cfg.replace(dtype="float32")
    p32 = ssm.Params(**{k: v.float() for k, v in params.named_parameters()})
    want, want_cache = ssm.prefill(p32, cfg32, x.float(), impl="chunked")
    assert mk.launches == n + 2
    err = (got.float() - want).abs()
    plain_err = (plain.float() - want).abs()
    assert float(err.max()) <= float(plain_err.max())
    assert float(err.mean()) <= float(plain_err.mean())
    assert torch.equal(cache["conv"], plain_cache["conv"])
    s_err = float((cache["state"] - want_cache["state"]).abs().max())
    assert s_err <= 2e-2 * float(want_cache["state"].abs().max())


@pytest.mark.cuda
def test_mixer_launches_two_a_full_sequence_call(cuda_device):
    cfg, params = _model("mamba2-780m", "bfloat16", cuda_device)
    x = torch.randn(2, 64, cfg.d_model, device=cuda_device).to(
        torch.bfloat16)
    with spans.enable():
        spans.clear()
        ssm.forward(params, cfg, x)
        _, cache = ssm.prefill(params, cfg, x[:, :37])
        ssm.prefill(params, cfg, x, impl="chunked")
        n = mk.launches
        ssm.decode_step(params, cfg, x[:, :1], cache)
        assert mk.launches == n + 1          # the gate; the conv is plain
        got = [s.fields["mixer_launches"] for s in spans.finished()
               if s.name == "ssm"]
        spans.clear()
    assert got == [2, 2, 0]
    assert math.isfinite(float(cache["state"].abs().max()))
