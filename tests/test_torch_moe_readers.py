"""The benchmark's readers of the mixtral cell (``portbench/metrics/``
``moe_ms``, ``moe_roofline``, ``flash_roofline``, ``moe_serve_mfu``) on a
synthetic traced serving round, and the counts they read
(``portbench/counts/mixtral.py``, ``counts/flash.py``) against values
worked by hand."""
import sys
from pathlib import Path

import pytest

from repro_torch.telemetry import spans

pytestmark = pytest.mark.telemetry

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.lib import common  # noqa: E402

BF16_PEAK, HBM = 989e12, 3.35e12
# a small shape, worked by hand below
SMALL = dict(n_layers=1, d_model=4, n_heads=2, n_kv_heads=1, head_dim=2,
             d_ff=3, n_experts=2, top_k=1, vocab_size=5, dtype="bfloat16")
MODEL = common.config("mixtral-8x22b")["model"]
# the traced round's MoE calls: (routed rows, experts hit, device s)
CALLS = [(73728, 8, 0.075), (73728, 8, 0.080), (16, 7, 0.003),
         (16, 8, 0.0025)]


@pytest.fixture(autouse=True)
def fresh_ring():
    assert not spans.recording()
    spans.clear()
    yield
    spans.clear()


def _reader(name):
    return common.load_module("metrics", name).read


def _counts(name):
    return common.load_module("counts", name)


def _round():
    """A traced serving round in the program's shape: the MoE calls of a
    split group and of decode, and a second, untraced root after it that
    the readers must not take (they take the last ``serve.round``)."""
    with spans.enable():
        with spans.span("serve.round"):
            with spans.span("serve.cell"):
                with spans.span("serve.split_group"):
                    for rows, _, _ in CALLS[:2]:
                        with spans.span("moe", routed_rows=rows):
                            pass
                with spans.span("serve.decode"):
                    for rows, _, _ in CALLS[2:]:
                        with spans.span("moe", routed_rows=rows):
                            pass
        with spans.span("moe", routed_rows=1):        # outside any round
            pass
    got = spans.finished()
    calls = [s for s in got if s.name == "moe"]
    for s, (rows, hit, dev_s) in zip(calls, CALLS + [(1, 1, 9.0)]):
        s.set(experts_hit=hit)
        s.device_s = dev_s
    for s in got:
        if s.name != "moe":
            s.device_s = 0.0
    return got


def _ctx(**kw):
    ctx = dict(trace={}, st=dict(cfg=dict(model=MODEL)))
    ctx.update(kw)
    return ctx


# ---------------------------------------------------------------- counts
def test_mixtral_counts_by_hand():
    c = _counts("mixtral")
    # projections 2·4·2·(2·2 + 2·1) = 96, router 2·4·2 = 16, one expert
    # 3·2·4·3 = 72
    assert c.token_flops(SMALL) == 96 + 16 + 72
    # positions 0..2 attend 1, 2, 3 keys: 4·2·2·6
    assert c.score_flops(SMALL, 0, 3) == 96
    # prefill 3·184 + 96, one decode step 184 + 4·2·2·4, the head twice
    assert c.request_flops(SMALL, 3, 2) == 648 + 248 + 2 * 40
    assert c.moe_flops(SMALL, 10) == 720
    # two experts' three 4x3 matrices and 10 rows of 4 in and out, bf16
    assert c.moe_bytes(SMALL, 10, 2) == 2 * (2 * 36 + 2 * 40)


def test_mixtral_counts_at_published_width():
    """At Mixtral's widths: 1.21 GFLOP of experts and 0.18 GFLOP of
    projections a token and layer; a decode call touching all eight
    experts reads their 4.83 GB."""
    c = _counts("mixtral")
    assert c.expert_flops(MODEL) * 2 == pytest.approx(1.208e9, rel=1e-3)
    proj = c.token_flops(MODEL) - 2 * c.expert_flops(MODEL) \
        - 2 * 6144 * 8
    assert proj == pytest.approx(0.1762e9, rel=1e-3)
    assert c.moe_bytes(MODEL, 0, 8) == pytest.approx(4.832e9, rel=1e-3)


def test_flash_ops_by_hand():
    assert _counts("flash").flash_ops(2, 8, 3, 4) == 2 * 2 * 3 * 4 * 64


# --------------------------------------------------------------- readers
def test_moe_ms():
    read = _reader("moe_ms")
    assert read(_ctx()) is None                     # nothing recorded
    _round()
    assert read(_ctx()) == pytest.approx(1e3 * sum(t for _, _, t in CALLS))
    assert read(_ctx(trace=None)) is None            # an untraced run


def test_moe_roofline():
    read = _reader("moe_roofline")
    assert read(_ctx()) is None
    _round()
    c = _counts("mixtral")
    need = sum(max(c.moe_flops(MODEL, rows) / BF16_PEAK,
                   c.moe_bytes(MODEL, rows, hit) / HBM)
               for rows, hit, _ in CALLS)
    got = read(_ctx())
    assert got == pytest.approx(100 * need / sum(t for _, _, t in CALLS))
    # prefill calls are bound by their FLOPs, decode calls by the experts'
    # bytes
    assert c.moe_flops(MODEL, 73728) / BF16_PEAK > \
        c.moe_bytes(MODEL, 73728, 8) / HBM
    assert c.moe_bytes(MODEL, 16, 7) / HBM > c.moe_flops(MODEL, 16) \
        / BF16_PEAK
    assert 0 < got <= 100
    for s in spans.finished():
        s.device_s = None                            # the CPU's spans
    assert read(_ctx()) is None


class _Path:
    """A runner that lays out one round's flash calls."""

    def __init__(self, shapes):
        self.shapes = shapes

    def flash_calls(self, st):
        return self.shapes


def test_flash_roofline():
    read = _reader("flash_roofline")
    shapes = [(8, 4608)] * 2
    kernels = [(0.0, 2600.0, "flash_wg_kernel"), (2600.0, 2700.0, "gemm"),
               (2700.0, 5400.0, "flash_wg_kernel")]
    st = dict(cfg=dict(model=MODEL), mix=dict(prompt_len=4608))
    ctx = dict(trace=dict(kernels=kernels), st=st, path=_Path(shapes))
    ops = _counts("flash").flash_ops(8, 4608, 48, 128)
    assert read(ctx) == pytest.approx(100 * 2 * ops / BF16_PEAK / 5.3e-3)
    # a stretch of two rounds: the round's calls laid out again
    ctx["trace"] = dict(kernels=kernels * 2)
    assert read(ctx) == pytest.approx(100 * 2 * ops / BF16_PEAK / 5.3e-3)
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, trace=dict(kernels=kernels[1:2]))) is None
    assert read(dict(ctx, path=object())) is None    # another runner


def test_moe_serve_mfu():
    read = _reader("moe_serve_mfu")

    class Path:
        @staticmethod
        def requests_per_round(st):
            return 16

    rounds = [dict(t0=0.0, t1=2.0), dict(t0=2.0, t1=4.5),
              dict(t0=4.5, t1=6.5)]
    rec = dict(rounds=rounds, marks=dict(trace_start=2.1, trace_end=4.4))
    st = dict(cfg=dict(model=MODEL),
              mix=dict(prompt_len=4608, decode_steps=8))
    got = read(dict(rec=rec, st=st, path=Path))
    per_round = 16 * _counts("mixtral").request_flops(MODEL, 4608, 8)
    assert got == pytest.approx(100 * 2 * per_round / (4.0 * BF16_PEAK))
    assert 0 < got < 100
    rec["marks"] = dict(trace_start=0.0, trace_end=7.0)
    assert read(dict(rec=rec, st=st, path=Path)) is None
