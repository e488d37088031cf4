"""The dropless MoE (``capacity_factor=None``, ``repro_torch.models.moe``)
against the benchmark's plain reference (``portbench/reference/
mixtral.py``) on the CPU: the layer alone, a row alone against the same
row in a batch, a served cell's prefill and decode logits through the
port's normal path (``engine.execute_schedule``), the decode start taken
from mixed split groups' caches, the ``moe`` span and the dropped-route
counter, and the refusal of a DTensor.  The tiny mixtral in float32 with
seeded weights; its attention made global, as the reference's is."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core import network, profiles
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serving import engine, split_runtime
from repro_torch.serving.scheduler import Schedule
from repro_torch.telemetry import spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import mixtral as ref  # noqa: E402

U, S, STEPS = 6, 24, 4


@pytest.fixture(autouse=True)
def fresh_ring():
    spans.clear()
    yield
    spans.clear()


def _cfg(capacity_factor=None):
    return get_tiny_config("mixtral-8x22b").replace(
        dtype="float32", pattern=(("attn", "moe"),),
        capacity_factor=capacity_factor, norm_eps=1e-5)


def _ref_cfg(cfg):
    return dict(n_layers=cfg.n_layers, d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps, n_experts=cfg.n_experts,
                top_k=cfg.top_k)


def _ref_weights(model):
    """The reference's weight dict over the program's ``Params``."""
    mixer = ("wq", "wk", "wv", "wo")
    ffn = ("router", "w_in", "w_gate", "w_out")
    layers = {n: torch.stack([getattr(lay.mixer, n) for lay in model.layers])
              for n in mixer}
    layers.update({n: torch.stack([getattr(lay.ffn, n)
                                   for lay in model.layers]) for n in ffn})
    for n in ("norm1", "norm2"):
        layers[n] = torch.stack([getattr(lay, n) for lay in model.layers])
    return dict(embed=model.embed, layers=layers,
                final_norm=model.final_norm, lm_head=model.lm_head)


def _ffn(cfg, seed=0, router=None):
    p = moe.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    if router == "one_expert":
        # equal probabilities: every token's first choice is expert 0 (the
        # lower index wins a tie), its second expert 1
        p.router.data.zero_()
    return p


def _x(cfg, shape=(4, S), seed=1):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32))


def _layer_weights(p):
    return dict(router=p.router, w_in=p.w_in, w_gate=p.w_gate,
                w_out=p.w_out)


# ---------------------------------------------------------- (a) the layer
@pytest.mark.parametrize("router", ["seeded", "one_expert"])
def test_dropless_layer_equals_reference(router):
    cfg = _cfg()
    p = _ffn(cfg, router=router)
    x = _x(cfg)
    y, _ = moe.forward(p, cfg, x)
    want, idx = ref.moe(x.reshape(-1, cfg.d_model), _layer_weights(p),
                        _ref_cfg(cfg), ref._keep)
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, rtol=1e-5,
                               atol=1e-6)
    got_idx, _, _ = moe.route(p, cfg, x.reshape(-1, cfg.d_model))
    assert torch.equal(got_idx, idx)
    if router == "one_expert":
        assert (idx[:, 0] == 0).all()
        # the capacity path drops most of those routes
        capped, _ = moe.forward(p, cfg.replace(capacity_factor=1.25), x)
        assert not torch.allclose(capped, y, rtol=1e-3, atol=1e-3)


# ------------------------------------------------ (b) a row on its own
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_row_alone_equals_row_in_batch(capacity_factor):
    """Dropless, a row's output does not depend on the rows beside it;
    under a capacity (the skewed router overfills experts 0 and 1), it
    does, which is why the engine prefills such a cell whole."""
    cfg = _cfg(capacity_factor=capacity_factor)
    p = _ffn(cfg, router="one_expert")
    x = _x(cfg)
    whole, _ = moe.forward(p, cfg, x)
    alone, _ = moe.forward(p, cfg, x[2:3])
    if capacity_factor is None:
        torch.testing.assert_close(alone[0], whole[2], rtol=1e-5, atol=1e-6)
    else:
        assert not torch.allclose(alone[0], whole[2], rtol=1e-3, atol=1e-3)


# ------------------------------------------- (c), (d) the served cell
def _schedule(split):
    one = np.ones(U, np.float32)
    return Schedule(split=np.asarray(split), subchannel_up=np.zeros(U, int),
                    subchannel_dn=np.zeros(U, int), power_up=one * 0.1,
                    power_dn=one, compute_units=one, pred_latency=one,
                    pred_energy=one, uplink_rate=one * 1e6,
                    downlink_rate=one * 1e6, gamma=0.0, iters=0)


def _served(model, cfg, split, toks, monkeypatch):
    """``execute_schedule`` with decode, recording the logits of every
    served token: the prompt's last position (the split groups' forward)
    and each decode step."""
    first, steps = {}, []
    infer, decode = split_runtime.split_inference, T.decode_step

    def split_inference(params, cfg_, tokens, split_, **kw):
        logits, bits = infer(params, cfg_, tokens, split_, **kw)
        first[split_] = logits[:, -1]
        return logits, bits

    def decode_step(*a, **kw):
        logits, caches = decode(*a, **kw)
        steps.append(logits)
        return logits, caches

    monkeypatch.setattr(split_runtime, "split_inference", split_inference)
    monkeypatch.setattr(T, "decode_step", decode_step)
    prof = profiles.transformer_profile(cfg, seq=S, device="cpu")
    ncfg = network.small_config(n_users=U, n_subchannels=3)
    sched = _schedule(split)
    with spans.enable():
        spans.clear()
        got = engine.execute_schedule(model, cfg, ncfg, prof, sched, toks,
                                      decode_steps=STEPS)
    tokens = np.stack([r.tokens_out for r in got])
    head = torch.empty((U, cfg.padded_vocab))
    for s_, users in sched.groups().items():
        head[torch.as_tensor(users)] = first[s_]
    logits = torch.stack([head] + steps, 1)               # (U, STEPS, V)
    return tokens, logits, spans.finished()


@pytest.mark.parametrize("layout", ["split0", "spread"])
def test_served_logits_equal_reference(layout, monkeypatch):
    cfg = _cfg()
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    split = np.zeros(U, int) if layout == "split0" \
        else np.arange(U) % (cfg.n_layers + 1)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (U, S))
    tokens, logits, got = _served(model, cfg, split, toks, monkeypatch)
    seq = torch.as_tensor(np.concatenate([toks, tokens[:, :-1]], 1))
    with torch.no_grad():
        want = ref.logits_at(_ref_weights(model), _ref_cfg(cfg), seq, S - 1)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    # every MoE call is a span inside the group's forward or decode
    by_id = {s.span_id: s for s in got}
    calls = [s for s in got if s.name == "moe"]
    assert len(calls) == cfg.n_layers * (len(np.unique(split)) + STEPS - 1)
    assert {by_id[s.parent_id].name for s in calls} == {
        "serve.split_group", "serve.decode"}


def test_mixed_split_groups_decode_from_their_caches(monkeypatch):
    """Several split groups in a cell: decode starts from the groups'
    caches (no whole-cell prefill) and serves the tokens the whole-cell
    prefill and its decode give."""
    cfg = _cfg()
    model = T.init(torch.Generator().manual_seed(0), cfg, "cpu")
    split = np.arange(U) % (cfg.n_layers + 1)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (U, S))
    logits, caches, _ = T.prefill(model, cfg, torch.as_tensor(toks),
                                  max_seq=S + STEPS + 1)
    cur = torch.argmax(logits[:, -1], -1)
    outs = [cur]
    for step in range(STEPS - 1):
        logits, caches = T.decode_step(model, cfg, cur, S + step, caches)
        cur = torch.argmax(logits, -1)
        outs.append(cur)
    want = torch.stack(outs, 1).numpy()
    tokens, _, got = _served(model, cfg, split, toks, monkeypatch)
    (start,) = [s for s in got if s.name == "serve.prefill"]
    assert start.fields == {"reused_rows": U, "prefilled_rows": 0}
    np.testing.assert_array_equal(tokens, want)


# --------------------------------------------- (e) the span and counter
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_moe_span_and_dropped_route_counter(capacity_factor):
    cfg = _cfg(capacity_factor=capacity_factor)
    p = _ffn(cfg, router="one_expert")
    x = _x(cfg)
    t = x.shape[0] * x.shape[1]
    moe.DROPPED_ROUTES.reset()
    with spans.enable():
        spans.clear()
        moe.forward(p, cfg, x)
        moe.forward(p, cfg, x[:1])
    big, small = [s for s in spans.finished() if s.name == "moe"]
    if capacity_factor is None:
        cap_big, cap_small, dropped = t, S, 0
    else:
        cap_big, cap_small = moe.capacity(cfg, t), moe.capacity(cfg, S)
        dropped = 2 * (t - cap_big) + 2 * (S - cap_small)
        assert dropped > 0
    assert big.fields == {"tokens": t, "routed_rows": 2 * t,
                          "shared_rows": 0,
                          "experts_hit": 2, "max_expert_rows": cap_big,
                          "dropped_rows": 2 * (t - cap_big)}
    assert small.fields["max_expert_rows"] == cap_small
    assert all(type(v) is int for v in big.fields.values())
    assert moe.DROPPED_ROUTES.read() == dropped
    moe.DROPPED_ROUTES.reset()
    assert moe.DROPPED_ROUTES.read() == 0


def test_untraced_call_keeps_no_span_and_counts_no_drop():
    cfg = _cfg()
    moe.DROPPED_ROUTES.reset()
    moe.forward(_ffn(cfg), cfg, _x(cfg))
    assert not spans.recording() and spans.finished() == []
    assert moe.DROPPED_ROUTES.read() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [8, 4096])
def test_dropless_makes_no_host_sync(tokens):
    """On the card the dropless path, its span's counts included, never
    waits for the device (a sync raises under the debug mode)."""
    if not torch.cuda.is_available():
        pytest.skip("host syncs are a card's")
    cfg = _cfg().replace(dtype="bfloat16")
    p = moe.init(torch.Generator().manual_seed(0), cfg, "cuda")
    x = _x(cfg, (1, tokens)).to("cuda", torch.bfloat16)
    moe.forward(p, cfg, x)
    torch.cuda.synchronize()
    with spans.enable():
        torch.cuda.set_sync_debug_mode("error")
        try:
            moe.forward(p, cfg, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    (sp,) = [s for s in spans.finished() if s.name == "moe"]
    assert sp.fields["dropped_rows"] == 0
    assert sp.fields["max_expert_rows"] <= tokens


# ------------------------------------------------------- (f) a DTensor
def test_dropless_refuses_a_dtensor():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import dryrun

    cfg = _cfg()
    p = _ffn(cfg)
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1,))
        x = distribute_tensor(_x(cfg), mesh, [Replicate()])
        with pytest.raises(ValueError, match="dropless MoE runs on plain"):
            moe.forward(p, cfg, x)
