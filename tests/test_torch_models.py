"""The port's served models (``repro_torch.models``, ``configs``,
``serving.split_runtime`` and the transformer profiles) against the JAX
package on the CPU.  Weights come from the JAX ``init`` and cross over
through ``interop.model_from_numpy``; inputs are made with numpy from a
seed.  JAX runs its plain model paths (``impl="naive"`` attention, the
associative RG-LRU scan): its Pallas kernels do not trace on this jax.
The port runs each attention path, ``"kernel"`` included, whose CPU
dispatch is the kernel's plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import profiles as jprof
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serving import split_runtime as jsplit
from repro_torch import configs, interop
from repro_torch.core import profiles
from repro_torch.models import attention, common, rglru, ssm
from repro_torch.models import transformer as T
from repro_torch.serving import split_runtime

CPU = "cpu"
# the eight model cases: the hybrid at its tiny depth (one full pattern
# unit) and at depth 5 (a unit plus a (rec, rec) tail), three
# attention-only families, the SSM and the two mixtures of experts; S=96
# makes the tiny window of 64 bind (mixtral's sliding window too) and is
# three chunks of the tiny mamba2's 32
MODEL_CASES = [("recurrentgemma-2b", {}),
               ("recurrentgemma-2b", {"n_layers": 5}),
               ("gemma-2b", {}), ("gemma3-12b", {}), ("llama3-8b", {}),
               ("mamba2-780m", {}), ("mixtral-8x22b", {}),
               ("dbrx-132b", {})]
MODEL_IDS = ["rg2b", "rg2b-l5", "gemma2b", "gemma3", "llama3", "mamba2",
             "mixtral", "dbrx"]
SEQ = 96


def _scaled_close(got, want, bar, what=""):
    """max |got - want| <= bar · max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) + 1e-30
    err = np.max(np.abs(got - want)) / scale
    assert err <= bar, f"{what}: scaled error {err:.3e} > {bar}"


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cfgs(name, **kw):
    jcfg = jconfigs.get_tiny_config(name).replace(dtype="float32", **kw)
    cfg = configs.get_tiny_config(name).replace(dtype="float32", **kw)
    return jcfg, cfg


@pytest.fixture(scope="module", params=MODEL_CASES, ids=MODEL_IDS)
def model_case(request):
    """JAX params and the port's model carrying the same weights."""
    name, kw = request.param
    jcfg, cfg = _cfgs(name, **kw)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    return jcfg, cfg, jparams, model, tokens


# ---------------------------------------------------------------- configs
def test_configs_equal_jax():
    assert configs.list_architectures() == jconfigs.list_architectures()
    for name in configs.list_architectures():
        for get in ("get_config", "get_tiny_config"):
            got = getattr(configs, get)(name)
            want = getattr(jconfigs, get)(name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.layer_specs == want.layer_specs
            assert got.tail_specs == want.tail_specs


# ------------------------------------------------------------- primitives
def test_rms_norm_activate_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    tx, tw = torch.as_tensor(x), torch.as_tensor(w)
    for gemma in (False, True):
        np.testing.assert_allclose(
            _np(common.rms_norm(tx, tw, 1e-6, gemma_style=gemma)),
            np.asarray(jcommon.rms_norm(x, w, 1e-6, gemma_style=gemma)),
            rtol=1e-5, atol=1e-6)
    for kind in ("silu", "geglu", "gelu"):
        np.testing.assert_allclose(
            _np(common.activate(tx, tx * 0.5, kind)),
            np.asarray(jcommon.activate(x, x * 0.5, kind)),
            rtol=1e-5, atol=1e-6)
    pos = np.broadcast_to(np.arange(7)[None] + 3, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(common.rope_freqs(64, 1e4),
                                  jcommon.rope_freqs(64, 1e4))
    np.testing.assert_allclose(
        _np(common.apply_rope(tx, torch.as_tensor(pos), 1e4)),
        np.asarray(jcommon.apply_rope(x, pos, 1e4)), rtol=1e-5, atol=1e-5)
    mpos = np.stack([pos, pos + 1, pos * 2], axis=1)
    np.testing.assert_allclose(
        _np(common.apply_mrope(tx, torch.as_tensor(mpos), 1e4, (8, 12, 12))),
        np.asarray(jcommon.apply_mrope(x, mpos, 1e4, (8, 12, 12))),
        rtol=1e-5, atol=1e-5)


def test_dense_init_is_a_truncated_standard_normal_times_fan_in():
    g = torch.Generator().manual_seed(0)
    w = common.dense_init(g, (400, 300), torch.float32, CPU)
    std = 1.0 / np.sqrt(400)
    assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)
    # a standard normal cut at ±2 has standard deviation 0.8796
    np.testing.assert_allclose(float(w.std()) / std, 0.8796, rtol=0.02)
    # each tensor draws its own stream from the host generator
    w2 = common.dense_init(g, (400, 300), torch.float32, CPU)
    assert not torch.equal(w, w2)
    again = common.dense_init(torch.Generator().manual_seed(0), (400, 300),
                              torch.float32, CPU)
    assert torch.equal(w, again)


# ------------------------------------------------------------- attention
@pytest.fixture(scope="module")
def attn_case():
    jcfg, cfg = _cfgs("gemma3-12b")          # GQA 4:2, head_dim 64, window 64
    jp = jattn.init(jax.random.PRNGKey(3), jcfg)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(2).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32) * 0.5
    pos = np.broadcast_to(np.arange(SEQ)[None], (2, SEQ)).astype(np.int32)
    return jcfg, cfg, jp, p, x, pos


@pytest.mark.parametrize("impl", ["naive", "chunked", "chunked_tri", "kernel"])
@pytest.mark.parametrize("mixer", ["attn", "local"])
def test_attention_forward_matches_jax(attn_case, mixer, impl):
    jcfg, cfg, jp, p, x, pos = attn_case
    want = jattn.forward(jp, jcfg, x, pos, mixer=mixer, impl="naive")
    got = attention.forward(p, cfg, torch.as_tensor(x), torch.as_tensor(pos),
                            mixer=mixer, impl=impl, q_chunk=32)
    _scaled_close(_np(got), want, 1e-5, f"{mixer}/{impl}")


@pytest.mark.parametrize("mixer", ["attn", "local"])
def test_attention_prefill_and_ring_decode_match_jax(attn_case, mixer):
    jcfg, cfg, jp, p, x, pos = attn_case
    max_seq = SEQ + 8
    jy, jc = jattn.prefill(jp, jcfg, x, pos, max_seq, mixer=mixer)
    y, c = attention.prefill(p, cfg, torch.as_tensor(x), torch.as_tensor(pos),
                             max_seq, mixer=mixer, impl="kernel")
    _scaled_close(_np(y), jy, 1e-5, "prefill")
    for f in ("k", "v"):
        _scaled_close(_np(c[f]), jc[f], 1e-5, f)
    np.testing.assert_array_equal(_np(c["pos"]), np.asarray(jc["pos"]))
    rng = np.random.default_rng(4)
    for t in range(SEQ, SEQ + 6):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jattn.decode_step(jp, jcfg, xt, jnp.int32(t), jc,
                                   mixer=mixer)
        y, c = attention.decode_step(p, cfg, torch.as_tensor(xt), t, c,
                                     mixer=mixer)
        _scaled_close(_np(y), jy, 1e-5, f"decode {t}")
        np.testing.assert_array_equal(_np(c["pos"]), np.asarray(jc["pos"]))


# ---------------------------------------------------------------- RG-LRU
@pytest.fixture(scope="module")
def rec_case():
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp = jrglru.init(jax.random.PRNGKey(1), jcfg)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(5).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32) * 0.3
    return jcfg, cfg, jp, p, x


def test_rglru_forward_matches_jax(rec_case):
    jcfg, cfg, jp, p, x = rec_case
    jy, jh = jrglru.forward(jp, jcfg, x)
    y, h = rglru.forward(p, cfg, torch.as_tensor(x))
    _scaled_close(_np(y), jy, 1e-5, "y")
    _scaled_close(_np(h), jh, 1e-5, "h")
    h0 = np.random.default_rng(6).standard_normal(
        (2, cfg.resolved_d_rnn)).astype(np.float32)
    jy, jh = jrglru.forward(jp, jcfg, x, init_h=h0)
    y, h = rglru.forward(p, cfg, torch.as_tensor(x),
                         init_h=torch.as_tensor(h0))
    _scaled_close(_np(y), jy, 1e-5, "y from h0")
    _scaled_close(_np(h), jh, 1e-5, "h from h0")


def test_rglru_prefill_and_decode_match_jax(rec_case):
    jcfg, cfg, jp, p, x = rec_case
    jy, jc = jrglru.prefill(jp, jcfg, x)
    y, c = rglru.prefill(p, cfg, torch.as_tensor(x))
    _scaled_close(_np(y), jy, 1e-5, "prefill y")
    for f in ("conv", "h"):
        _scaled_close(_np(c[f]), jc[f], 1e-5, f)
    rng = np.random.default_rng(7)
    for t in range(5):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) * 0.3
        jy, jc = jrglru.decode_step(jp, jcfg, xt, jc)
        y, c = rglru.decode_step(p, cfg, torch.as_tensor(xt), c)
        _scaled_close(_np(y), jy, 1e-5, f"decode {t}")
        _scaled_close(_np(c["h"]), jc["h"], 1e-5, f"h {t}")
    # a prefill shorter than the conv history pads it on the left
    jy, jc = jrglru.prefill(jp, jcfg, x[:, :2])
    y, c = rglru.prefill(p, cfg, torch.as_tensor(x[:, :2]))
    _scaled_close(_np(c["conv"]), jc["conv"], 1e-5, "short conv")


def test_rglru_init_lambda_range():
    _, cfg = _cfgs("recurrentgemma-2b")
    p = rglru.init(torch.Generator().manual_seed(0), cfg, CPU)
    a_c = torch.exp(-cfg.rglru_c * torch.nn.functional.softplus(p.lam))
    assert float(a_c.min()) >= 0.9 - 1e-5 and float(a_c.max()) <= 0.999 + 1e-5


# --------------------------------------------------------------- Mamba-2
@pytest.fixture(scope="module")
def ssm_case():
    jcfg, cfg = _cfgs("mamba2-780m")
    jp = jssm.init(jax.random.PRNGKey(2), jcfg)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(9).standard_normal(
        (2, 100, cfg.d_model)).astype(np.float32) * 0.5
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_ssm_forward_matches_jax(ssm_case, impl):
    """The mixer at 3 chunks of 32, through the plain chunked scan and the
    kernel's dispatch (its plain version on the CPU)."""
    jcfg, cfg, jp, p, x = ssm_case
    want = jssm.forward(jp, jcfg, x[:, :96])
    got = ssm.forward(p, cfg, torch.as_tensor(x[:, :96]), impl=impl)
    _scaled_close(_np(got), want, 1e-5, impl)


def test_ssm_prefill_and_decode_match_jax(ssm_case):
    jcfg, cfg, jp, p, x = ssm_case
    jy, jc = jssm.prefill(jp, jcfg, x[:, :96])
    y, c = ssm.prefill(p, cfg, torch.as_tensor(x[:, :96]))
    _scaled_close(_np(y), jy, 1e-5, "prefill y")
    for f in ("conv", "state"):
        _scaled_close(_np(c[f]), jc[f], 1e-5, f)
    assert c["state"].dtype == torch.float32
    rng = np.random.default_rng(10)
    for t in range(5):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32) * 0.5
        jy, jc = jssm.decode_step(jp, jcfg, xt, jc)
        y, c = ssm.decode_step(p, cfg, torch.as_tensor(xt), c)
        _scaled_close(_np(y), jy, 1e-5, f"decode {t}")
        for f in ("conv", "state"):
            _scaled_close(_np(c[f]), jc[f], 1e-5, f"{f} {t}")
    # a prefill shorter than the conv history pads it on the left
    jy, jc = jssm.prefill(jp, jcfg, x[:, :2])
    y, c = ssm.prefill(p, cfg, torch.as_tensor(x[:, :2]))
    _scaled_close(_np(c["conv"]), jc["conv"], 1e-5, "short conv")
    _scaled_close(_np(y), jy, 1e-5, "short y")


def test_ssm_ragged_prefill_matches_jax(ssm_case):
    """L = 100 at chunk 32: the port's chunked scan (kernel dispatch and
    plain) masks the ragged last chunk where JAX's prefill takes its
    sequential scan; outputs, conv history and state agree, and so do a
    full model's prefill logits."""
    jcfg, cfg, jp, p, x = ssm_case
    jy, jc = jssm.prefill(jp, jcfg, x)
    for impl in ("kernel", "naive"):
        y, c = ssm.prefill(p, cfg, torch.as_tensor(x), impl=impl)
        _scaled_close(_np(y), jy, 1e-5, f"{impl} y")
        for f in ("conv", "state"):
            _scaled_close(_np(c[f]), jc[f], 1e-5, f"{impl} {f}")
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    tokens = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    jl, _, _ = JT.prefill(jparams, jcfg, tokens, max_seq=104)
    lg, caches, _ = T.prefill(model, cfg, torch.as_tensor(tokens),
                              max_seq=104)
    _scaled_close(_np(lg), jl, 1e-4, "ragged prefill logits")
    assert [tuple(c_["state"].shape) for c_ in caches] == \
        [(2, cfg.n_ssd_heads, cfg.ssd_head_dim, cfg.d_state)] * cfg.n_layers


def test_ssm_forward_raises_at_ragged_length(ssm_case):
    """As the JAX forward asserts L % min(chunk, L) == 0."""
    _, cfg, _, p, x = ssm_case
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssm.forward(p, cfg, torch.as_tensor(x))
    model = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        T.forward(model, cfg, torch.zeros((1, 100), dtype=torch.int64))


def test_ssm_init_dt_bias_range():
    """softplus(dt_bias) spans [1e-3, 0.1] (the Mamba-2 default), A_log
    is log(1..H), D is 1."""
    _, cfg = _cfgs("mamba2-780m")
    full = configs.get_config("mamba2-780m")
    for c in (cfg, full):
        p = ssm.init(torch.Generator().manual_seed(0), c, CPU)
        dt = torch.nn.functional.softplus(p.dt_bias)
        assert p.dt_bias.dtype == torch.float32
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
        assert float(dt.max()) <= 0.1 * (1 + 1e-5)
        np.testing.assert_allclose(
            _np(p.A_log), np.log(np.arange(1, c.n_ssd_heads + 1)), rtol=1e-6)
        assert torch.equal(p.D, torch.ones(c.n_ssd_heads))
    assert tuple(p.in_proj.shape) == (1536, 2 * 3072 + 2 * 128 + 48)
    assert p.in_proj.dtype == torch.bfloat16


# ------------------------------------------------------------ full model
def test_model_from_numpy_has_init_layout(model_case):
    jcfg, cfg, jparams, model, _ = model_case
    fresh = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    shapes = lambda m: {n: (tuple(x.shape), x.dtype)
                        for n, x in m.named_parameters()}
    assert shapes(model) == shapes(fresh)
    assert T.param_count(model) == JT.param_count(jparams)


def test_model_from_numpy_keeps_bfloat16_bits():
    jcfg = jconfigs.get_tiny_config("recurrentgemma-2b")
    cfg = configs.get_tiny_config("recurrentgemma-2b")
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device=CPU)
    want = np.asarray(jparams["embed"]).astype(np.float32)
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.float().numpy(), want)
    assert model.layers[0].mixer.w_a.dtype == torch.float32


def test_model_from_numpy_keeps_ssm_dtypes():
    """bf16 mamba2 weights keep their bits; A_log, dt_bias and D stay
    float32, as the JAX init makes them."""
    jcfg = jconfigs.get_tiny_config("mamba2-780m")
    cfg = configs.get_tiny_config("mamba2-780m")
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device=CPU)
    jmix = jax.tree.map(lambda v: np.asarray(v)[1],
                        jparams["units"][0]["mixer"])
    mix = model.layers[1].mixer
    for name in ("A_log", "dt_bias", "D"):
        assert getattr(mix, name).dtype == torch.float32, name
        np.testing.assert_array_equal(_np(getattr(mix, name)), jmix[name])
    for name in ("in_proj", "conv_w", "norm_w", "out_proj"):
        assert getattr(mix, name).dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            getattr(mix, name).float().numpy(),
            jmix[name].astype(np.float32))
    fresh = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    assert {n: x.dtype for n, x in model.named_parameters()} == \
        {n: x.dtype for n, x in fresh.named_parameters()}


@pytest.mark.parametrize("impl", ["naive", "kernel"])
def test_full_model_logits_match_jax(model_case, impl):
    jcfg, cfg, jparams, model, tokens = model_case
    want, jaux = JT.forward(jparams, jcfg, tokens)
    got, aux = T.forward(model, cfg, torch.as_tensor(tokens), impl=impl)
    assert got.dtype == torch.float32
    if cfg.arch_type != "moe":
        assert aux == 0.0
    # the MoE router's aux loss, summed over the layers
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    _scaled_close(_np(got), want, 1e-4, impl)


def test_prefill_decode_tokens_match_jax(model_case):
    jcfg, cfg, jparams, model, tokens = model_case
    n_steps, s = 5, tokens.shape[1]
    jl, jc, jaux = JT.prefill(jparams, jcfg, tokens, max_seq=s + n_steps + 1)
    lg, c, aux = T.prefill(model, cfg, torch.as_tensor(tokens),
                           max_seq=s + n_steps + 1, impl="kernel")
    _scaled_close(_np(lg), jl, 1e-4, "prefill logits")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    jcur = jnp.argmax(jl[:, -1], -1)
    cur = torch.argmax(lg[:, -1], -1)
    np.testing.assert_array_equal(_np(cur), np.asarray(jcur))
    for step in range(n_steps):
        jl, jc = JT.decode_step(jparams, jcfg, jcur, jnp.int32(s + step), jc)
        lg, c = T.decode_step(model, cfg, cur, s + step, c)
        _scaled_close(_np(lg), jl, 1e-4, f"decode {step}")
        jcur, cur = jnp.argmax(jl, -1), torch.argmax(lg, -1)
        np.testing.assert_array_equal(_np(cur), np.asarray(jcur))


def test_decode_from_empty_caches_matches_forward(model_case):
    """Decoding token by token from ``init_caches`` gives the full
    forward's logits at every position.  An MoE FFN's capacity follows the
    token count (GShard: 12 tokens in the forward, 2 per decode step), so
    there the capacity factor is raised until no slot drops in either."""
    jcfg, cfg, jparams, model, tokens = model_case
    if cfg.arch_type == "moe":
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts))
    toks = torch.as_tensor(tokens[:, :6])
    full, _ = T.forward(model, cfg, toks)
    caches = T.init_caches(cfg, 2, 8, device=CPU)
    for t in range(6):
        lg, caches = T.decode_step(model, cfg, toks[:, t], t, caches)
        _scaled_close(_np(lg), _np(full[:, t]), 1e-4, f"position {t}")


def test_split_runtime_matches_jax(model_case):
    jcfg, cfg, jparams, model, tokens = model_case
    full, _ = T.forward(model, cfg, torch.as_tensor(tokens), impl="kernel")
    for s in (0, 1, cfg.n_layers // 2, cfg.n_layers):
        got, bits = split_runtime.split_inference(
            model, cfg, torch.as_tensor(tokens), s, impl="kernel")
        _, jbits = jsplit.split_inference(jparams, jcfg, tokens, s)
        assert bits == jbits
        # the split path runs the fused path's operations in its order
        assert torch.equal(got, full), s
        assert split_runtime.layer_params(model, cfg, s % cfg.n_layers)[1] \
            == jsplit.layer_params(jparams, jcfg, s % cfg.n_layers)[1]


def test_musicgen_and_vlm_embeddings_match_jax():
    """Codebook sums and prepended vision embeddings (embed_tokens and
    lm_logits only: their blocks are attention + dense, held above)."""
    for name in ("musicgen-medium", "qwen2-vl-72b"):
        jcfg, cfg = _cfgs(name)
        jparams = JT.init(jax.random.PRNGKey(0), jcfg)
        model = interop.model_from_numpy(
            cfg, jax.tree.map(np.asarray, jparams), device=CPU)
        rng = np.random.default_rng(8)
        shape = (2, cfg.n_codebooks, 10) if cfg.n_codebooks > 1 else (2, 10)
        toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        ve = None
        if cfg.vision_tokens:
            ve = rng.standard_normal(
                (2, cfg.vision_tokens, cfg.d_model)).astype(np.float32) * 0.02
        want, _ = JT.forward(jparams, jcfg, toks, vision_embeds=ve)
        got, _ = T.forward(model, cfg, torch.as_tensor(toks),
                           vision_embeds=None if ve is None
                           else torch.as_tensor(ve))
        _scaled_close(_np(got), want, 1e-4, name)


@pytest.mark.parametrize("name", configs.list_architectures())
def test_every_family_builds_and_runs_on_cpu(name):
    """Every registered family, the two MoE ones included, builds from
    ``transformer.init`` on the CPU and runs one forward to finite
    logits."""
    cfg = configs.get_tiny_config(name)
    model = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    assert len(model.layers) == cfg.n_layers
    shape = (2, cfg.n_codebooks, 32) if cfg.n_codebooks > 1 else (2, 32)
    toks = torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(1))
    logits, aux = T.forward(model, cfg, toks)
    assert logits.shape[:2] == (2, 32)
    assert logits.shape[-1] == cfg.padded_vocab
    assert bool(torch.isfinite(logits).all())
    assert (float(aux) > 0) == (cfg.arch_type == "moe")


# --------------------------------------------------------------- profiles
@pytest.mark.parametrize("name,seq", [("recurrentgemma-2b", 512),
                                      ("gemma-2b", 128), ("llama3-8b", 64),
                                      ("mamba2-780m", 256),
                                      ("qwen2-vl-72b", 32),
                                      ("musicgen-medium", 32)])
def test_transformer_profile_equals_jax(name, seq):
    got = profiles.transformer_profile(configs.get_config(name), seq=seq,
                                       device=CPU)
    want = jprof.transformer_profile(jconfigs.get_config(name), seq=seq)
    assert got.name == want.name
    np.testing.assert_array_equal(_np(got.layer_flops),
                                  np.asarray(want.layer_flops))
    np.testing.assert_array_equal(_np(got.out_bits), np.asarray(want.out_bits))
    assert got.input_bits == want.input_bits
    assert got.result_bits == want.result_bits
    by_name = profiles.get_profile(name, CPU, seq=seq)
    np.testing.assert_array_equal(_np(by_name.layer_flops),
                                  _np(got.layer_flops))
