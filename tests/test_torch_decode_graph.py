"""Decode on static buffers (``serving.engine.DecodeBuffers``), captured
as a CUDA graph on a card.

On the CPU: the decode steps that the buffers run, held to the steps as
they were before the buffers (the position a host int, fresh cache
tensors every step) computed here: attention at a device position
(global, local with its ring wrapping, M-RoPE's (B, 3, 1) positions), and
the Mamba-2 and RG-LRU caches updated in place.  One set of buffers
serves rounds back to back, split groups placed at their rows, with the
tokens of the whole-cell reference; the CPU and an MoE model decode
eagerly (``graphed`` false).

The ``cuda`` cases hold the graphed decode on the card to the eager
decode of the same model (buffers with ``graphed`` false): tokens equal
and every step's logits within 1e-6 of the largest, over two rounds of
other prompts, mixed split groups, a second batch size with its own
capture, and an MoE model that decodes eagerly."""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core import network, profiles
from repro_torch.models import attention, rglru, ssm
from repro_torch.models import transformer as T
from repro_torch.models.common import gelu
from repro_torch.serving import engine
from repro_torch.serving.scheduler import Schedule
from repro_torch.telemetry import spans

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_serve_cache_reuse import whole_cell_decode

U, STEPS = 8, 12


def _model(name, device="cpu", dtype=None):
    cfg = get_tiny_config(name)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return cfg, T.init(torch.Generator().manual_seed(0), cfg, device)


def _layer(model, cfg, mixer):
    i = next(i for i, (m, _) in enumerate(cfg.layer_specs) if m == mixer)
    return model.layers[i].mixer, i


def _cloned(cache):
    return {k: v.clone() for k, v in cache.items()}


def _assert_same_caches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------ attention
def _host_position_step(params, cfg, x, pos, cache, mixer):
    """``attention.decode_step`` as it was before the graph: the position
    a host int, its slot written by a host index."""
    b = x.shape[0]
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    shape = (b, 3, 1) if cfg.mrope_sections is not None else (b, 1)
    positions = torch.full(shape, pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = attention._project_qkv(params, cfg, x, positions)
    idx = pos % cache["k"].shape[1]
    cache["k"][:, idx] = k_new[:, 0]
    cache["v"][:, idx] = v_new[:, 0]
    cache["pos"][idx] = pos
    cpos = cache["pos"]
    window = cfg.window if mixer == "local" else 0
    valid = (cpos >= 0) & (cpos <= pos)
    if window:
        valid &= cpos > pos - window
    kf = attention._expand_kv(cache["k"], cfg.n_heads)
    vf = attention._expand_kv(cache["v"], cfg.n_heads)
    out = attention._sdpa(q, kf, vf, valid[None, None, None, :], scale)
    return attention._out_proj(params, out), cache


@pytest.mark.parametrize("name,mixer,prompt", [
    ("gemma-2b", "attn", 20),
    ("recurrentgemma-2b", "local", 60),     # window 64: the ring wraps
    ("qwen2-vl-72b", "attn", 20),           # M-RoPE, positions (B, 3, 1)
])
def test_attention_decode_at_a_device_position(name, mixer, prompt):
    cfg, model = _model(name, dtype="float32")
    params, _ = _layer(model, cfg, mixer)
    g = torch.Generator().manual_seed(1)
    b, n = 3, 12
    x0 = torch.randn(b, prompt, cfg.d_model, generator=g)
    positions = torch.arange(prompt)[None].expand(b, prompt)
    if cfg.mrope_sections is not None:
        positions = positions[:, None].expand(b, 3, prompt)
    _, cache = attention.prefill(params, cfg, x0, positions,
                                 max_seq=prompt + n + 1, mixer=mixer,
                                 impl="naive")
    want_cache, by_int = _cloned(cache), _cloned(cache)
    pos = torch.tensor(prompt)
    for _ in range(n):
        x = torch.randn(b, 1, cfg.d_model, generator=g)
        p = int(pos)
        want, want_cache = _host_position_step(params, cfg, x, p,
                                               want_cache, mixer)
        got, back = attention.decode_step(params, cfg, x, pos, cache,
                                          mixer=mixer)
        assert back is cache
        assert torch.equal(got, want)
        _assert_same_caches(cache, want_cache)
        # an int position is taken too, and is the same step
        again, _ = attention.decode_step(params, cfg, x, p, by_int,
                                         mixer=mixer)
        assert torch.equal(again, want)
        _assert_same_caches(by_int, want_cache)
        pos += 1
    if mixer == "local":
        assert prompt + n > cfg.window


# ---------------------------------------------------- recurrent caches
def _fresh_ssm_step(params, cfg, x, cache):
    """Mamba-2's decode step with fresh cache tensors (the step before
    the graph, its SSD update written out)."""
    b = x.shape[0]
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
    z, xbc, dt_raw = ssm._split(cfg, x @ params.in_proj)
    hist = torch.cat([cache["conv"], xbc], dim=1)
    conv_out = torch.nn.functional.silu(
        torch.einsum("bwc,wc->bc", hist, params.conv_w) + params.conv_b)
    xs = conv_out[:, :di].reshape(b, h, cfg.ssd_head_dim)
    B, C = conv_out[:, di:di + n], conv_out[:, di + n:]
    dt = torch.nn.functional.softplus(dt_raw[:, 0].float() + params.dt_bias)
    A = -torch.exp(params.A_log)
    xf = xs.float()
    decay = torch.exp(dt * A)[:, :, None, None]
    upd = dt[:, :, None, None] * xf[:, :, :, None] \
        * B.float()[:, None, None, :]
    state = decay * cache["state"] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C.float())
    y = (y + xf * params.D[None, :, None]).to(xs.dtype)
    return ssm._out(params, cfg, y[:, None], z, "kernel"), {
        "conv": hist[:, 1:, :], "state": state}


def _fresh_rglru_step(params, cfg, x, cache):
    """The RG-LRU's decode step with fresh cache tensors."""
    xr1 = (x @ params.proj_rec)[:, 0]
    hist = torch.cat([cache["conv"], xr1[:, None, :]], dim=1)
    xr = (torch.einsum("bwr,wr->br", hist, params.conv_w)
          + params.conv_b).float()
    gate = gelu((x @ params.proj_gate)[:, 0].float())
    a, b = rglru._gates(params, cfg, xr)
    h = a * cache["h"] + b
    y = ((h * gate).to(x.dtype) @ params.out_proj)[:, None, :]
    return y, {"conv": hist[:, 1:, :], "h": h}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,mixer,module,fresh", [
    ("mamba2-780m", "ssd", ssm, _fresh_ssm_step),
    ("recurrentgemma-2b", "rec", rglru, _fresh_rglru_step),
])
def test_recurrent_decode_updates_its_cache_in_place(name, mixer, module,
                                                     fresh, dtype):
    cfg, model = _model(name, dtype=dtype)
    params, _ = _layer(model, cfg, mixer)
    g = torch.Generator().manual_seed(2)
    b = 3
    x0 = torch.randn(b, 32, cfg.d_model, generator=g).to(model.embed.dtype)
    _, cache = module.prefill(params, cfg, x0)
    cache = _cloned(cache)
    want_cache = _cloned(cache)
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    tensors = dict(cache)
    for _ in range(6):
        x = torch.randn(b, 1, cfg.d_model, generator=g).to(x0.dtype)
        want, want_cache = fresh(params, cfg, x, want_cache)
        got, back = module.decode_step(params, cfg, x, cache)
        assert back is cache
        assert all(back[k] is tensors[k] for k in tensors)
        assert {k: v.data_ptr() for k, v in back.items()} == ptrs
        assert torch.equal(got, want)
        _assert_same_caches(cache, want_cache)


# ------------------------------------------------- the buffers, CPU
def _schedule(split):
    one = np.ones(len(split), np.float32)
    n = len(split)
    return Schedule(split=np.asarray(split), subchannel_up=np.zeros(n, int),
                    subchannel_dn=np.zeros(n, int), power_up=one * 0.1,
                    power_dn=one, compute_units=one, pred_latency=one,
                    pred_energy=one, uplink_rate=one * 1e6,
                    downlink_rate=one * 1e6, gamma=0.0, iters=0)


def _tokens(cfg, s, seed, users=U):
    shape = (users, cfg.n_codebooks, s) if cfg.n_codebooks > 1 \
        else (users, s)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _serve(model, cfg, split, toks, steps=STEPS):
    device = model.embed.device
    prof = profiles.transformer_profile(cfg, seq=toks.shape[-1],
                                        device=device)
    ncfg = network.small_config(n_users=len(split), n_subchannels=3)
    return engine.execute_schedule(model, cfg, ncfg, prof,
                                   _schedule(split), toks,
                                   decode_steps=steps)


def _split(cfg, layout, users=U):
    return np.arange(users) % (cfg.n_layers + 1) if layout == "spread" \
        else np.zeros(users, int)


def test_no_graph_on_the_cpu_or_for_an_moe():
    """Every model gets buffers; their steps are graphed on a card, and
    never on the CPU nor for a model with an MoE FFN."""
    for name, on_a_card in (("mamba2-780m", True), ("mixtral-8x22b", False)):
        cfg, model = _model(name)
        bufs = engine._decode_buffers(model, cfg, U, 40)
        assert engine._BUFFERS[model] is bufs and not bufs.graphed
        assert engine._graphed(cfg, torch.device("cuda")) == on_a_card


@pytest.mark.parametrize("layout", ["spread", "split0"])
@pytest.mark.parametrize("name", ["mamba2-780m", "recurrentgemma-2b",
                                  "gemma-2b", "musicgen-medium"])
def test_buffers_serve_rounds_back_to_back(name, layout):
    """Two rounds of other prompts on one set of buffers, each split
    group's caches placed at its users' rows as the blocks make them: each
    round gives the tokens of the whole cell prefilled and decoded
    (``whole_cell_decode``), and the second makes no new buffers."""
    cfg, model = _model(name, dtype="float32")
    split = _split(cfg, layout)
    # recurrentgemma's prompt fills its window of 64: the ring wraps
    prompt = 64 if name == "recurrentgemma-2b" else 32
    made = []
    for seed in (3, 4):
        toks = _tokens(cfg, prompt, seed)
        want, _ = whole_cell_decode(model, cfg, toks, STEPS)
        got = [r.tokens_out for r in _serve(model, cfg, split, toks)]
        np.testing.assert_array_equal(np.stack(got), want)
        made.append(engine._BUFFERS[model])
    assert made[1] is made[0]


# --------------------------------------------------------------- a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA graph is captured and replayed only on a card")
    return torch.device("cuda")


def _recorded_decode(rec):
    """``transformer.decode_step`` that also writes each step's float32
    logits into ``rec`` (rows, positions, V) at the step's position, on
    the device: a captured step records every replay's logits."""
    step = T.decode_step

    def recorded(params, cfg, tokens, pos, caches, **kw):
        logits, caches = step(params, cfg, tokens, pos, caches, **kw)
        at = torch.as_tensor(pos, device=logits.device).view(1)
        rec.index_copy_(1, at, logits.float()[:, None])
        return logits, caches

    return recorded


def _counts():
    return engine.DECODE_GRAPH.captures, engine.DECODE_GRAPH.replays


@contextlib.contextmanager
def _eager(model, cfg, users, max_seq):
    """The model's decode buffers of this shape new, with ``graphed``
    false, for the ``with`` block; let go after it."""
    engine._BUFFERS.pop(model, None)
    engine._decode_buffers(model, cfg, users, max_seq).graphed = False
    try:
        yield
    finally:
        engine._BUFFERS.pop(model, None)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["spread", "split0"])
@pytest.mark.parametrize("name,prompt", [("mamba2-780m", 64),
                                         ("recurrentgemma-2b", 64),
                                         ("gemma-2b", 64)])
def test_graphed_decode_matches_eager_on_the_card(name, prompt, layout,
                                                  cuda_device, monkeypatch):
    """Two rounds back to back with other prompts: the graphed decode's
    tokens equal the eager decode's, and every step's logits lie within
    1e-6 of the largest; the first round captures, the second replays
    every step.  recurrentgemma's prompt fills its window of 64, so its
    ring wraps."""
    cfg, model = _model(name, cuda_device)
    split = _split(cfg, layout)
    max_seq = prompt + STEPS + 1
    rec = torch.zeros((U, max_seq, cfg.padded_vocab), device=cuda_device)
    monkeypatch.setattr(T, "decode_step", _recorded_decode(rec))
    rounds = [_tokens(cfg, prompt, seed) for seed in (5, 6)]

    def serve_all():
        out = []
        for t in rounds:
            res = _serve(model, cfg, split, t)
            out.append((np.stack([r.tokens_out for r in res]),
                        rec[:, prompt:prompt + STEPS - 1].clone()))
        return out

    with _eager(model, cfg, U, max_seq):
        want = serve_all()
    c0, r0 = _counts()
    with spans.enable():
        spans.clear()
        got = serve_all()
    decodes = [s for s in spans.finished() if s.name == "serve.decode"]
    spans.clear()
    assert _counts() == (c0 + 1, r0 + 2 * (STEPS - 1) - 1)
    # the decode-attention kernel launches in the eager first step only:
    # the capture launches nothing and a replay is not counted
    n_attn = sum(m in ("attn", "local") for m, _ in cfg.layer_specs)
    assert [(s.fields["graphed"], s.fields["captures"], s.fields["replays"],
             s.fields["attn_launches"])
            for s in decodes] == [(True, 1, STEPS - 2, n_attn),
                                  (True, 0, STEPS - 1, 0)]
    for (gt, gl), (wt, wl) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        tol = 1e-6 * float(wl.abs().max())
        torch.testing.assert_close(gl, wl, rtol=0, atol=tol)


@pytest.mark.cuda
def test_a_second_batch_size_gets_its_own_capture(cuda_device):
    """Rounds of 8, 4 and 4 users: the second size captures a graph of
    its own, which its next round replays; every round's tokens are the
    eager decode's."""
    cfg, model = _model("mamba2-780m", cuda_device)
    toks = _tokens(cfg, 32, 7)
    sizes = (U, U // 2, U // 2)
    want = []
    for users in sizes:
        with _eager(model, cfg, users, 32 + STEPS + 1):
            want.append([r.tokens_out for r in _serve(
                model, cfg, _split(cfg, "spread", users), toks[:users])])
    captures = []
    for users, w in zip(sizes, want):
        c0, _ = _counts()
        got = [r.tokens_out for r in _serve(
            model, cfg, _split(cfg, "spread", users), toks[:users])]
        np.testing.assert_array_equal(np.stack(got), np.stack(w))
        captures.append(_counts()[0] - c0)
    assert captures == [1, 1, 0]


@pytest.mark.cuda
def test_moe_decodes_eagerly_on_the_card(cuda_device):
    cfg, model = _model("mixtral-8x22b", cuda_device)
    split = _split(cfg, "split0")
    c0 = _counts()
    with spans.enable():
        spans.clear()
        _serve(model, cfg, split, _tokens(cfg, 64, 8))
    (dec,) = [s for s in spans.finished() if s.name == "serve.decode"]
    spans.clear()
    n_attn = sum(m in ("attn", "local") for m, _ in cfg.layer_specs)
    bufs = engine._BUFFERS[model]
    assert dec.fields == {"steps": STEPS - 1, "graphed": False,
                          "captures": 0, "replays": 0,
                          "attn_launches": (STEPS - 1) * n_attn,
                          "ssm_state_bytes": 0,
                          "kv_bytes": bufs.kv_bytes}
    assert bufs.kv_bytes == sum(c[k].numel() * c[k].element_size()
                                for c in bufs.caches for k in c)
    assert _counts() == c0
    assert not engine._BUFFERS[model].graphed
