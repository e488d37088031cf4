"""The benchmark's readers of the granite cell (``portbench/metrics/``
``ssm_ms``, ``granite_ssd_roofline``, ``granite_moe_roofline``,
``granite_serve_mfu``) on a synthetic traced serving round, the counts
they read (``portbench/counts/granite.py``) against values worked by
hand, and the program's spans and fields they read: the ``ssm`` span of
each full-sequence Mamba-2 call, the ``moe`` span's ``shared_rows``."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.models import ssm
from repro_torch.telemetry import spans

pytestmark = pytest.mark.telemetry

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.lib import common  # noqa: E402

BF16_PEAK, HBM = 989e12, 3.35e12
# a small shape, worked by hand below: a Mamba-2 layer (di 8, 4 heads of
# 2, state 2, conv 2, chunk 2) and an attention layer (2 heads of 2 over
# one kv head), each with 2 experts of 3 (top-1) and a shared one of 5
SMALL = dict(hidden_size=4, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=3, shared_intermediate_size=5,
             num_local_experts=2, num_experts_per_tok=1, vocab_size=5,
             mamba_expand=2, mamba_d_state=2, mamba_n_heads=4,
             mamba_d_head=2, mamba_d_conv=2, mamba_chunk_size=2,
             layer_types=["mamba", "attention"], num_hidden_layers=2,
             dtype="bfloat16")
CFG = common.config("granite-4.0-h-small")
# the traced round's MoE calls: (routed rows, experts hit, shared rows,
# device s): two prefill calls, two decode calls
CALLS = [(327680, 72, 32768, 0.060), (327680, 72, 32768, 0.062),
         (80, 47, 8, 0.004), (80, 50, 8, 0.0045)]


@pytest.fixture(autouse=True)
def fresh_ring():
    assert not spans.recording()
    spans.clear()
    yield
    spans.clear()


def _reader(name):
    return common.load_module("metrics", name).read


def _counts():
    return common.load_module("counts", "granite")


# ---------------------------------------------------------------- counts
def test_granite_counts_by_hand():
    c = _counts()
    assert c.expert_flops(SMALL) == 3 * 2 * 4 * 3
    assert c.shared_flops(SMALL) == 3 * 2 * 4 * 5
    # router 2·4·2 + one expert 72 + the shared one 120
    assert c.ffn_flops(SMALL) == 16 + 72 + 120
    # q, o 2·4·2·2 each, k, v 2·4·1·2 each
    assert c.mixer_flops(SMALL, "attention") == 96
    # in_proj 2·4·(2·8 + 2·2 + 4), out_proj 2·8·4, conv 2·2·(8 + 2·2)
    assert c.mixer_flops(SMALL, "mamba") == 192 + 64 + 48
    assert c.score_flops(SMALL, 0, 3) == 4 * 2 * 2 * 6
    # a request of 3 prompt tokens served 2: the head twice (2·40); the
    # Mamba-2 layer's 4 tokens (304 + 208 each), its SSD over the prompt
    # (chunks of 2 and 1: 304) and one decode step's state (4·4·2·2); the
    # attention layer's 4 tokens (96 + 208 each) and scores over 10 keys
    mamba = 4 * (304 + 208) + 304 + 64
    attn = 4 * (96 + 208) + 4 * 2 * 2 * 10
    assert c.request_flops(SMALL, 3, 2) == 80 + mamba + attn
    assert c.moe_flops(SMALL, 10, 4) == 10 * 72 + 4 * 120
    # two experts' and the shared expert's three matrices, 10 routed and 4
    # shared rows of 4 in and out, bf16
    assert c.moe_bytes(SMALL, 10, 2, 4) == 2 * (3 * 4 * (2 * 3 + 5)
                                               + 2 * 14 * 4)
    assert c.moe_bytes(SMALL, 10, 2, 0) == 2 * (3 * 4 * 2 * 3 + 2 * 10 * 4)


def test_granite_counts_at_published_width():
    """Per token and layer 188.7 MFLOP of routed experts and 37.7 of the
    shared one; ~8.6 GFLOP a prompt token over the 20 layers; a decode
    call touching all 72 experts reads their 1.36 GB."""
    c = _counts()
    assert 10 * c.expert_flops(CFG) == pytest.approx(188.74e6, rel=1e-4)
    assert c.shared_flops(CFG) == pytest.approx(37.75e6, rel=1e-3)
    per_token = c.request_flops(CFG, 4096, 8) / (4096 + 7)
    assert per_token == pytest.approx(8.57e9, rel=1e-2)
    assert c.moe_bytes(CFG, 0, 72, 0) == pytest.approx(1.359e9, rel=1e-3)


# ------------------------------------------------------- program's spans
def test_ssm_span_of_each_full_sequence_call():
    cfg = configs.get_tiny_config("granite-4.0-h-small").replace(
        dtype="float32")
    p = ssm.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(3, 64, cfg.d_model)
    with spans.enable():
        ssm.forward(p, cfg, x)
        _, cache = ssm.prefill(p, cfg, x[:2, :40])
        ssm.decode_step(p, cfg, x[:2, :1], cache)
    got = [s for s in spans.finished()]
    assert [s.name for s in got] == ["ssm", "ssm"]
    # the mixer kernels launch on a card only: 0 here
    assert [s.fields for s in got] == [
        dict(rows=3, tokens=192, heads=cfg.n_ssd_heads, mixer_launches=0),
        dict(rows=2, tokens=80, heads=cfg.n_ssd_heads, mixer_launches=0)]
    # untraced, nothing is kept
    ssm.forward(p, cfg, x)
    assert len(spans.finished()) == 2


# --------------------------------------------------------------- readers
def _round():
    """A traced serving round: a split group's ``ssm`` and ``moe`` calls,
    decode's ``moe`` calls, and a call outside any round that the readers
    must not take."""
    with spans.enable():
        with spans.span("serve.round"):
            with spans.span("serve.cell"):
                with spans.span("serve.split_group"):
                    for rows, _, shared, _ in CALLS[:2]:
                        with spans.span("ssm", rows=8, tokens=32768,
                                        heads=128):
                            pass
                        with spans.span("moe", routed_rows=rows,
                                        shared_rows=shared):
                            pass
                with spans.span("serve.decode"):
                    for rows, _, shared, _ in CALLS[2:]:
                        with spans.span("moe", routed_rows=rows,
                                        shared_rows=shared):
                            pass
        with spans.span("moe", routed_rows=1, shared_rows=1):
            pass
    got = spans.finished()
    calls = [s for s in got if s.name == "moe"]
    for s, (_, hit, _, dev_s) in zip(calls, CALLS + [(1, 1, 1, 9.0)]):
        s.set(experts_hit=hit)
        s.device_s = dev_s
    for s in got:
        if s.name == "ssm":
            s.device_s = 0.05
        elif s.name != "moe":
            s.device_s = 0.0
    return got


def _ctx(**kw):
    ctx = dict(trace={}, st=dict(cfg=CFG))
    ctx.update(kw)
    return ctx


def test_ssm_ms():
    read = _reader("ssm_ms")
    assert read(_ctx()) is None                      # nothing recorded
    _round()
    assert read(_ctx()) == pytest.approx(1e3 * 2 * 0.05)
    assert read(_ctx(trace=None)) is None            # an untraced run


def test_granite_moe_roofline():
    read = _reader("granite_moe_roofline")
    assert read(_ctx()) is None
    _round()
    c = _counts()
    need = sum(max(c.moe_flops(CFG, rows, sh) / BF16_PEAK,
                   c.moe_bytes(CFG, rows, hit, sh) / HBM)
               for rows, hit, sh, _ in CALLS)
    got = read(_ctx())
    assert got == pytest.approx(100 * need / sum(t for *_, t in CALLS))
    # prefill calls are bound by their FLOPs, decode calls by the experts'
    # bytes
    assert c.moe_flops(CFG, 327680, 32768) / BF16_PEAK > \
        c.moe_bytes(CFG, 327680, 72, 32768) / HBM
    assert c.moe_bytes(CFG, 80, 47, 8) / HBM > c.moe_flops(CFG, 80, 8) \
        / BF16_PEAK
    assert 0 < got <= 100
    for s in spans.finished():
        s.device_s = None                            # the CPU's spans
    assert read(_ctx()) is None


def test_granite_moe_roofline_needs_the_shared_rows():
    """A program whose ``moe`` span has no ``shared_rows`` (the parent
    of the field) reads nothing."""
    with spans.enable():
        with spans.span("serve.round"):
            with spans.span("moe", routed_rows=10, experts_hit=2):
                pass
    for s in spans.finished():
        s.device_s = 0.01
    assert _reader("granite_moe_roofline")(_ctx()) is None


class _Path:
    """A runner that lays out one round's ssd calls by their rows."""

    def __init__(self, rows):
        self.rows = rows

    def ssd_rows(self, st):
        return self.rows

    @staticmethod
    def requests_per_round(st):
        return 16


def test_granite_ssd_roofline():
    read = _reader("granite_ssd_roofline")
    launches = ("ssd_states_kernel", "ssd_pass_kernel", "ssd_out_kernel")
    kernels = []
    t = 0.0
    for _ in range(2):                               # two calls
        for name, us in zip(launches, (500.0, 300.0, 1500.0)):
            kernels.append((t, t + us, name))
            t += us
        kernels.append((t, t + 50.0, "gemm"))
        t += 50.0
    st = dict(cfg=CFG, mix=dict(prompt_len=4096))
    ctx = dict(trace=dict(kernels=kernels), st=st, path=_Path([8, 8]))
    ssd = common.load_module("counts", "ssd")
    shape = (8, 4096, 128, 64, 128)
    need = max(ssd.ssd_bytes(*shape) / HBM,
               ssd.ssd_ops(*shape, 256) / BF16_PEAK)
    got = read(ctx)
    assert got == pytest.approx(100 * 2 * need / 4.6e-3)
    assert 0 < got <= 100
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, path=object())) is None    # another runner
    assert read(dict(ctx, trace=dict(kernels=kernels[:2]))) is None


def test_granite_serve_mfu():
    read = _reader("granite_serve_mfu")
    rounds = [dict(t0=0.0, t1=3.0), dict(t0=3.0, t1=6.5),
              dict(t0=6.5, t1=9.5)]
    rec = dict(rounds=rounds, marks=dict(trace_start=3.1, trace_end=6.4))
    st = dict(cfg=CFG, mix=dict(prompt_len=4096, decode_steps=8))
    got = read(dict(rec=rec, st=st, path=_Path([])))
    per_round = 16 * _counts().request_flops(CFG, 4096, 8)
    assert got == pytest.approx(100 * 2 * per_round / (6.0 * BF16_PEAK))
    assert 0 < got < 100
    rec["marks"] = dict(trace_start=0.0, trace_end=10.0)
    assert read(dict(rec=rec, st=st, path=_Path([]))) is None
