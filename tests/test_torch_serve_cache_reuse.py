"""Decode continues from the caches that a serve round's split groups
put into the model's decode buffers (``serving.engine``): the same greedy
tokens as ``transformer.prefill`` over the whole cell followed by
``decode_step`` (``whole_cell_decode``), the same caches, each block run
once a group, and the whole cell run once more only where the groups'
forward differs from it (a capacity-bound MoE FFN across split groups).
Tiny float32 models on the CPU."""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny_config
from repro_torch.core import network, profiles
from repro_torch.models import blocks
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.serving.scheduler import Schedule
from repro_torch.telemetry import spans

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

U, S, STEPS = 8, 32, 3


def _model(name):
    cfg = get_tiny_config(name).replace(dtype="float32")
    return cfg, T.init(torch.Generator().manual_seed(0), cfg, "cpu")


def _schedule(split):
    one = np.ones(U, np.float32)
    return Schedule(split=np.asarray(split), subchannel_up=np.zeros(U, int),
                    subchannel_dn=np.zeros(U, int), power_up=one * 0.1,
                    power_dn=one, compute_units=one, pred_latency=one,
                    pred_energy=one, uplink_rate=one * 1e6,
                    downlink_rate=one * 1e6, gamma=0.0, iters=0)


def _tokens(cfg, s=S):
    shape = (U, cfg.n_codebooks, s) if cfg.n_codebooks > 1 else (U, s)
    return np.random.default_rng(7).integers(0, cfg.vocab_size, shape)


def whole_cell_decode(model, cfg, toks, steps):
    """The reference a served cell's decode is held to: the whole cell
    through ``transformer.prefill``, then ``decode_step``.  Returns each
    user's ``steps`` greedy tokens (U, steps, ...) and copies of the
    prefill's caches."""
    s = toks.shape[-1]
    logits, caches, _ = T.prefill(model, cfg, torch.as_tensor(toks),
                                  max_seq=s + steps + 1)
    cur = torch.argmax(logits[:, -1], -1)
    want_caches = [{k: v.clone() for k, v in c.items()} for c in caches]
    outs = [cur]
    for step in range(steps - 1):
        logits, caches = T.decode_step(model, cfg, cur, s + step, caches)
        cur = torch.argmax(logits, -1)
        outs.append(cur)
    return torch.stack(outs, 1).numpy(), want_caches


def _serve(model, cfg, split, toks, decode_steps):
    prof = profiles.transformer_profile(cfg, seq=toks.shape[-1],
                                        device="cpu")
    ncfg = network.small_config(n_users=U, n_subchannels=3)
    return engine.execute_schedule(model, cfg, ncfg, prof, _schedule(split),
                                   toks, decode_steps=decode_steps)


@pytest.mark.parametrize("layout", ["spread", "split0"])
@pytest.mark.parametrize("name", ["gemma-2b", "recurrentgemma-2b",
                                  "mamba2-780m", "llama3-8b",
                                  "mixtral-8x22b", "musicgen-medium"])
def test_decode_continues_from_split_group_caches(name, layout,
                                                  monkeypatch):
    cfg, model = _model(name)
    f = cfg.n_layers
    split = np.arange(U) % (f + 1) if layout == "spread" \
        else np.zeros(U, int)
    n_groups = len(np.unique(split))
    toks = _tokens(cfg)

    want_tokens, want_caches = whole_cell_decode(model, cfg, toks, STEPS)

    calls = collections.Counter()
    handed = []

    def counted(fn, kind):
        def run(p, *a, **kw):
            calls[kind, id(p)] += 1
            return fn(p, *a, **kw)
        return run

    def first_step(params, cfg_, tokens, pos, caches_, **kw):
        if not handed:
            handed.append(([{k: v.clone() for k, v in c.items()}
                            for c in caches_], caches_))
        return decode_step(params, cfg_, tokens, pos, caches_, **kw)

    decode_step = T.decode_step
    monkeypatch.setattr(blocks, "forward", counted(blocks.forward,
                                                   "forward"))
    monkeypatch.setattr(blocks, "prefill", counted(blocks.prefill,
                                                   "prefill"))
    monkeypatch.setattr(T, "decode_step", first_step)
    with spans.enable():
        spans.clear()
        got = _serve(model, cfg, split, toks, STEPS)
    (pre,) = [s for s in spans.finished() if s.name == "serve.prefill"]

    for r in got:
        np.testing.assert_array_equal(r.tokens_out, want_tokens[r.user])

    fallback = name == "mixtral-8x22b" and layout == "spread"
    assert pre.fields == {"reused_rows": 0 if fallback else U,
                          "prefilled_rows": U if fallback else 0}
    layers = {id(p) for p in model.layers}
    per_layer = {kind: [calls[kind, i] for i in layers]
                 for kind in ("forward", "prefill")}
    if fallback:
        assert per_layer == {"forward": [n_groups] * f, "prefill": [1] * f}
    else:
        assert per_layer == {"forward": [0] * f, "prefill": [n_groups] * f}

    reused, read = handed[0]
    # decode reads the cell's buffers, filled by the groups or the refill
    assert read is engine._BUFFERS[model].caches
    assert len(reused) == f
    for g, w in zip(reused, want_caches):
        assert g.keys() == w.keys()
        for k in w:
            if layout == "split0" or fallback:
                assert torch.equal(g[k], w[k]), k
            else:
                torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("decode_steps", [0, STEPS])
def test_ragged_mamba2_prompt_still_raises(decode_steps):
    """A prompt that is not a whole number of SSD chunks raises in a split
    group, with or without decode, though ``transformer.prefill`` takes
    it."""
    cfg, model = _model("mamba2-780m")
    s = cfg.ssd_chunk + 8
    toks = _tokens(cfg, s)
    T.prefill(model, cfg, torch.as_tensor(toks), max_seq=s + 4)
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        _serve(model, cfg, np.arange(U) % (cfg.n_layers + 1), toks,
               decode_steps)


@pytest.mark.parametrize("name", ["gemma-2b", "recurrentgemma-2b",
                                  "mamba2-780m"])
def test_decode_start_rows_decode_as_in_the_cell(name, monkeypatch):
    """``DecodeStart[rows]`` is those rows' start: the cell's two halves,
    decoded one after the other from their parts of one start, give the
    whole cell's tokens and each step's logits.  The prompt fills
    recurrentgemma's local window (64 positions), so decode's 16 steps
    wrap its ring buffer."""
    cfg, model = _model(name)
    split = np.zeros(U, int)
    toks = _tokens(cfg, 64)
    step_logits = []
    decode_step = T.decode_step

    def recorded(*a, **kw):
        logits, caches = decode_step(*a, **kw)
        step_logits.append(logits)
        return logits, caches

    monkeypatch.setattr(T, "decode_step", recorded)
    want = {r.user: r.tokens_out for r in _serve(model, cfg, split, toks,
                                                 16)}
    want_logits, step_logits[:] = torch.stack(step_logits, 1), []
    whole = engine._continue_decode

    def halves(params, cfg_, start, results, n_steps):
        n = start.shape[0] // 2
        for rows in (slice(0, n), slice(n, None)):
            part = {u - rows.start: r for u, r in results.items()
                    if u in range(U)[rows]}
            whole(params, cfg_, start[rows], part, n_steps)

    monkeypatch.setattr(engine, "_continue_decode", halves)
    for r in _serve(model, cfg, split, toks, 16):
        np.testing.assert_array_equal(r.tokens_out, want[r.user])
    n = len(step_logits) // 2
    got = torch.cat([torch.stack(step_logits[:n], 1),
                     torch.stack(step_logits[n:], 1)])
    torch.testing.assert_close(got, want_logits, rtol=1e-5, atol=1e-5)
