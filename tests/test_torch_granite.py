"""Granite 4.0-H (``granite-4.0-h-small``, a port-only configuration)
against the benchmark's plain reference (``portbench/reference/
granite.py``) on the CPU: the registry, the forward, a served cell's
prefill and decode logits through the port's normal path
(``engine.execute_schedule``, decoding on ``DecodeBuffers`` that hold
Mamba-2 states and a KV ring side by side), and one test each for NoPE,
the configured score scale, the shared expert and the multipliers; and
``profiles.block_flops`` counting the shared expert.  The tiny granite
(Mamba-2, attention, Mamba-2; 8 experts top-3 and a shared expert) in
float32 with seeded weights."""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import PortConfig
from repro_torch.core import network, profiles
from repro_torch.models import attention, blocks, ffn, moe
from repro_torch.models import transformer as T
from repro_torch.models.common import positions_for, rms_norm
from repro_torch.serving import engine, split_runtime
from repro_torch.serving.scheduler import Schedule
from repro_torch.telemetry import spans

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench.reference import granite as ref  # noqa: E402

NAME = "granite-4.0-h-small"
U, S, STEPS = 4, 64, 4


@pytest.fixture(autouse=True)
def fresh_ring():
    spans.clear()
    yield
    spans.clear()


def _cfg(**kw):
    return configs.get_tiny_config(NAME).replace(dtype="float32", **kw)


def _model(cfg, seed=0):
    return T.init(torch.Generator().manual_seed(seed), cfg, "cpu")


def _ref_cfg(cfg):
    """The reference's configuration (the published config's keys)."""
    return dict(
        hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads, intermediate_size=cfg.d_ff,
        shared_intermediate_size=cfg.shared_d_ff,
        num_local_experts=cfg.n_experts, num_experts_per_tok=cfg.top_k,
        vocab_size=cfg.vocab_size, mamba_n_heads=cfg.n_ssd_heads,
        mamba_d_head=cfg.ssd_head_dim, mamba_d_state=cfg.d_state,
        mamba_expand=cfg.ssd_expand, mamba_d_conv=cfg.conv_width,
        mamba_chunk_size=cfg.ssd_chunk, rms_norm_eps=cfg.norm_eps,
        attention_multiplier=cfg.attention_multiplier,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, num_hidden_layers=cfg.n_layers,
        layer_types=["attention" if m == "attn" else "mamba"
                     for m, _ in cfg.layer_specs])


def _ref_weights(model):
    """The reference's weight dict over the program's ``Params``."""
    layers = []
    for lay in model.layers:
        lw = {n: p for n, p in lay.mixer.named_parameters()}
        lw.update(norm1=lay.norm1, norm2=lay.norm2, router=lay.ffn.router,
                  w_in=lay.ffn.w_in, w_gate=lay.ffn.w_gate,
                  w_out=lay.ffn.w_out, shared_in=lay.ffn.shared.w_in,
                  shared_gate=lay.ffn.shared.w_gate,
                  shared_out=lay.ffn.shared.w_out)
        layers.append(lw)
    return dict(embed=model.embed, layers=layers,
                final_norm=model.final_norm)


def _tokens(cfg, seed=7, n=U, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, s))


# ---------------------------------------------------------- the registry
def test_registry_finds_the_port_only_configuration():
    cfg = configs.get_config(NAME)
    assert isinstance(cfg, PortConfig)
    assert NAME not in configs.list_architectures()
    assert configs.get_config(NAME + ":tiny") == configs.get_tiny_config(NAME)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == \
        (4096, 32, 8, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.shared_d_ff) == \
        (72, 10, 768, 1536)
    assert (cfg.n_ssd_heads, cfg.ssd_head_dim, cfg.d_state,
            cfg.ssd_chunk) == (128, 64, 128, 256)
    assert cfg.capacity_factor is None and cfg.tie_embeddings
    assert cfg.padded_vocab == cfg.vocab_size == 100352
    assert [i for i, (m, _) in enumerate(cfg.layer_specs) if m == "attn"] \
        == [5, 15, 25, 35]
    assert (cfg.position_embedding, cfg.attention_multiplier,
            cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling) == ("nope", 1 / 128, 12.0, 0.22, 16.0)
    # the registry's entries keep the JAX package's fields, and read the
    # port-only terms at their neutral values
    for name in configs.list_architectures():
        reg = configs.get_config(name)
        assert type(reg) is configs.ModelConfig
        assert "shared_d_ff" not in dataclasses.asdict(reg)
        assert (reg.shared_d_ff, reg.position_embedding,
                reg.attention_multiplier, reg.embedding_multiplier,
                reg.residual_multiplier, reg.logits_scaling) == \
            (0, "rope", 0.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="position_embedding"):
        cfg.replace(position_embedding="alibi")


# ---------------------------------------------------- the model's forward
def test_forward_equals_reference():
    cfg = _cfg()
    model = _model(cfg)
    toks = torch.as_tensor(_tokens(cfg))
    with torch.no_grad():
        got, _ = T.forward(model, cfg, toks)
        want = ref.logits_at(_ref_weights(model), _ref_cfg(cfg), toks, 0)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


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
        got = engine.execute_schedule(model, cfg, ncfg, prof, sched, toks,
                                      decode_steps=STEPS)
    tokens = np.stack([r.tokens_out for r in got])
    head = torch.empty((U, cfg.padded_vocab))
    for s_, users in sched.groups().items():
        head[torch.as_tensor(users)] = first[s_]
    return tokens, torch.stack([head] + steps, 1), spans.finished()


@pytest.mark.parametrize("layout", ["split0", "spread"])
def test_prefill_then_decode_equals_reference(layout, monkeypatch):
    """A served cell's logits at every served position, the split groups'
    forward then decode on the model's ``DecodeBuffers`` (two Mamba-2
    states and conv histories beside one KV ring), against the
    reference's full forward of the prompt and the served tokens."""
    cfg = _cfg()
    model = _model(cfg)
    split = np.zeros(U, int) if layout == "split0" \
        else np.arange(U) % (cfg.n_layers + 1)
    toks = _tokens(cfg)
    tokens, logits, got = _served(model, cfg, split, toks, monkeypatch)
    seq = torch.as_tensor(np.concatenate([toks, tokens[:, :-1]], 1))
    with torch.no_grad():
        want = ref.logits_at(_ref_weights(model), _ref_cfg(cfg), seq, S - 1)
    torch.testing.assert_close(logits, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
    bufs = engine._BUFFERS[model]
    kinds = [sorted(c) for c in bufs.caches]
    assert kinds == [["conv", "state"], ["k", "pos", "v"], ["conv", "state"]]
    (dec,) = [s for s in got if s.name == "serve.decode"]
    assert dec.fields["graphed"] is False
    # by hand, float32 buffers for 4 users and S + STEPS + 1 = 69
    # positions: the attention layer's k and v (2 kv heads of 64) and its
    # int64 ring of positions; two Mamba-2 layers' states (16 heads of 32
    # x state 32) and conv histories (3 x (512 + 2·32))
    assert dec.fields["kv_bytes"] == bufs.kv_bytes \
        == 2 * 4 * 69 * 2 * 64 * 4 + 69 * 8
    assert dec.fields["ssm_state_bytes"] == bufs.ssm_state_bytes \
        == 2 * 4 * (16 * 32 * 32 + 3 * 576) * 4


# ------------------------------------------------------------------ NoPE
def _attention_params(cfg, seed=3, gain=4.0):
    """An attention layer whose scores spread (std ~1 at gain 4 under the
    1/head_dim scale), so that positions and the scale show."""
    p = attention.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    p.wq.data.mul_(gain)
    p.wk.data.mul_(gain)
    return p


def _x(cfg, shape=(2, S), seed=1):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32))


def test_nope_attention_reads_no_position():
    """NoPE: the output does not depend on the positions handed in, and
    equals the reference's; the same layer with RoPE differs.  A decode
    step at a position one too far (the mixtral cell's fault) leaves a
    NoPE model's logits as they were."""
    cfg = _cfg()
    p = _attention_params(cfg)
    x = _x(cfg)
    pos = positions_for(cfg, 2, S, device="cpu")
    nope = attention.forward(p, cfg, x, pos)
    torch.testing.assert_close(
        attention.forward(p, cfg, x, pos + 100), nope, rtol=0, atol=0)
    lw = dict(wq=p.wq, wk=p.wk, wv=p.wv, wo=p.wo)
    torch.testing.assert_close(nope, ref.attention(x, lw, _ref_cfg(cfg),
                                                   ref._keep),
                               rtol=1e-4, atol=1e-5)
    rope = cfg.replace(position_embedding="rope")
    assert not torch.allclose(attention.forward(p, rope, x, pos), nope,
                              rtol=1e-2, atol=1e-3)
    # decode: the same steps at positions one too far
    model = _model(cfg)
    toks = torch.as_tensor(_tokens(cfg, n=2))
    outs = []
    for shift in (0, 1):
        _, caches, _ = T.prefill(model, cfg, toks, max_seq=S + STEPS + 1)
        cur, got = toks[:, -1], []
        for j in range(STEPS):
            logits, caches = T.decode_step(model, cfg, cur, S + j + shift,
                                           caches)
            got.append(logits)
        outs.append(torch.stack(got))
    # (the keys sit in other ring slots: the sums' order differs)
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-6)


def test_score_scale_is_the_configured_one():
    """The scores are scaled by ``attention_multiplier`` on the flash path
    and in decode (the reference's scale); 0 gives 1/sqrt(head_dim)."""
    cfg = _cfg()
    p = _attention_params(cfg)
    x = _x(cfg)
    pos = positions_for(cfg, 2, S, device="cpu")
    lw = dict(wq=p.wq, wk=p.wk, wv=p.wv, wo=p.wo)
    got = attention.forward(p, cfg, x, pos)
    want = ref.attention(x, lw, _ref_cfg(cfg), ref._keep)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    plain = cfg.replace(attention_multiplier=0.0)
    rc = dict(_ref_cfg(cfg), attention_multiplier=1 / math.sqrt(64))
    torch.testing.assert_close(attention.forward(p, plain, x, pos),
                               ref.attention(x, lw, rc, ref._keep),
                               rtol=1e-4, atol=1e-5)
    assert not torch.allclose(attention.forward(p, plain, x, pos), got,
                              rtol=1e-2, atol=1e-3)
    # decode at the last position: the prefill's cache, then one step
    y, cache = attention.prefill(p, cfg, x[:, :-1], pos[:, :-1], S)
    step, _ = attention.decode_step(p, cfg, x[:, -1:], S - 1, cache)
    torch.testing.assert_close(step[:, 0], want[:, -1], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------- shared expert
def test_shared_expert_adds_its_swiglu():
    """The MoE's output is the routed experts' (the same layer without a
    shared expert) plus the shared SwiGLU on every token, and equals the
    reference's; its span counts the shared rows."""
    cfg = _cfg()
    p = moe.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = _x(cfg)
    with spans.enable():
        y, _ = moe.forward(p, cfg, x)
        routed, _ = moe.forward(p, cfg.replace(shared_d_ff=0), x)
    torch.testing.assert_close(
        y, routed + ffn.forward(p.shared, cfg, x), rtol=1e-6, atol=1e-6)
    lw = dict(router=p.router, w_in=p.w_in, w_gate=p.w_gate, w_out=p.w_out,
              shared_in=p.shared.w_in, shared_gate=p.shared.w_gate,
              shared_out=p.shared.w_out)
    want, idx = ref.moe(x.reshape(-1, cfg.d_model), lw, _ref_cfg(cfg),
                        ref._keep)
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(moe.route(p, cfg, x.reshape(-1, cfg.d_model))[0],
                       idx)
    with_shared, without = [s for s in spans.finished() if s.name == "moe"]
    assert with_shared.fields["shared_rows"] == 2 * S
    assert with_shared.fields["routed_rows"] == 2 * S * cfg.top_k
    assert without.fields["shared_rows"] == 0


# ------------------------------------------------------------ multipliers
def test_multipliers():
    """The embedding times 12, each branch times 0.22 before its residual
    add, the logits divided by 16 (the head's input divided: for a power
    of two the same bits); at the neutral values the plain model."""
    cfg = _cfg()
    model = _model(cfg)
    toks = torch.as_tensor(_tokens(cfg, n=2))
    plain = cfg.replace(embedding_multiplier=1.0, residual_multiplier=1.0,
                        logits_scaling=1.0)
    torch.testing.assert_close(T.embed_tokens(model, cfg, toks),
                               12.0 * T.embed_tokens(model, plain, toks),
                               rtol=0, atol=0)
    x = _x(cfg)
    torch.testing.assert_close(T.lm_logits(model, cfg, x),
                               T.lm_logits(model, plain, x) / 16.0,
                               rtol=0, atol=0)
    # a block: x + 0.22 a, then + 0.22 m
    spec, layer = cfg.layer_specs[1], model.layers[1]
    pos = positions_for(cfg, 2, S, device="cpu")
    got, _ = blocks.forward(layer, cfg, spec, x, pos)
    a = attention.forward(layer.mixer, cfg,
                          rms_norm(x, layer.norm1, cfg.norm_eps), pos)
    x1 = x + 0.22 * a
    m, _ = moe.forward(layer.ffn, cfg, rms_norm(x1, layer.norm2,
                                                cfg.norm_eps))
    torch.testing.assert_close(got, x1 + 0.22 * m, rtol=1e-6, atol=1e-6)
    one, _ = blocks.forward(layer, plain, spec, x, pos)
    assert not torch.allclose(one, got, rtol=1e-2, atol=1e-3)
    y = torch.randn(2, S, cfg.d_model)
    assert torch.equal(blocks._residual(plain, x, y), x + y)


# --------------------------------------------------------------- profiles
def test_block_flops_count_the_shared_expert():
    """Per token of the published width: a Mamba-2 layer's projections
    2·4096·(2·8192 + 2·128 + 128) + 2·8192·4096, its SSD, the router
    2·4096·72, ten experts 10·3·2·4096·768 and the shared one
    3·2·4096·1536; an attention layer's in place of the Mamba-2 part."""
    cfg = configs.get_config(NAME)
    seq = 256
    moe_part = seq * (2 * 4096 * 72 + 10 * 3 * 2 * 4096 * 768
                      + 3 * 2 * 4096 * 1536)
    mamba = seq * (2 * 4096 * (2 * 8192 + 2 * 128 + 128) + 2 * 8192 * 4096) \
        + 2 * seq * 256 * 128 + 2 * seq * 256 * 128 * 64 \
        + 4 * seq * 128 * 64 * 128
    attn = seq * 2 * 4096 * (32 + 16) * 128 + 2 * seq * 32 * 128 * 4096 \
        + 2 * seq * seq * 32 * 128
    assert profiles.block_flops(cfg, ("ssd", "moe"), seq) == mamba + moe_part
    assert profiles.block_flops(cfg, ("attn", "moe"), seq) == attn + moe_part
    # without the shared expert the count is the routed layer's
    assert profiles.block_flops(cfg.replace(shared_d_ff=0), ("ssd", "moe"),
                                seq) == mamba + moe_part \
        - seq * 3 * 2 * 4096 * 1536
