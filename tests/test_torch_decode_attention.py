"""The decode-attention kernel (``kernels/decode_attention``) and the
decode step that routes to it.

On the CPU: the plain version (``ref.decode_attention_ref``) is the
model's plain decode attention (``_expand_kv`` then ``_sdpa``) bitwise,
over groups of 1, 2, 6 and 8 query heads a KV head, head dims 64, 128 and
256, partly filled caches, keys past the position, a window inside the
ring and a wrapped local ring; ``attention.decode_step`` on the CPU, with
a DTensor (a one-rank fake mesh) or with a score hook set, takes the plain
path and launches nothing; the wrapper's shape checks, its refusal of
CPU tensors and its split of the keys.

The ``cuda`` cases (run on a card with ``PYTHONPATH=src python -m pytest
--noconftest -m cuda tests/test_torch_decode_attention.py``; elsewhere
they skip from inside the ``cuda_device`` fixture) hold the kernel to the
plain version in float32 at mixtral-8x22b's full decode shape, gemma-2b's
MQA at D=256, recurrentgemma-2b's wrapped window and musicgen's MHA at
D=64 (no further off than the plain bf16 path, and within one bf16 ulp),
every split of the keys to the default one, a captured decode step's
replays to its eager steps bitwise, mixtral-tiny's served tokens with the
kernel to those of the plain path (the MoE's routes replayed from the
plain run; tokens part only at ties of bf16 logits), and the routing: no
``_expand_kv`` on the card, the plain path with a score hook or a
DTensor, and the wrapper refusing what the kernel does not take.  This
module imports no JAX."""
import math

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_tiny_config
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.launch import dryrun
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.common import Params

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

# b, ring size, h, kh, d, window, slots filled, position
CASES = {
    "mha_d64_partial": (2, 40, 4, 4, 64, 0, 30, 29),
    "g2_d128_full": (3, 48, 4, 2, 128, 0, 48, 47),
    "g6_d128_partial": (2, 70, 12, 2, 128, 0, 50, 49),
    "g6_d128_keys_past_pos": (2, 70, 12, 2, 128, 0, 50, 40),
    "g8_d256_mqa_partial": (1, 33, 8, 1, 256, 0, 20, 19),
    "g6_d64_window_in_ring": (1, 64, 6, 1, 64, 16, 40, 39),
    "g2_d256_wrapped_local": (2, 32, 4, 2, 256, 32, None, 75),
}
# mixtral-8x22b's decode shape (a 4608-token prompt, its first further
# step), gemma-2b's MQA at D=256, recurrentgemma-2b's window 2048 with the
# ring wrapped, musicgen-medium's MHA at D=64, and 20 query heads a KV head
# (two chunks of 16) at a cache shorter than a tile
CARD_CASES = {
    "mixtral": (8, 4617, 48, 8, 128, 0, 4609, 4608),
    "gemma_mqa_d256": (4, 1100, 8, 1, 256, 0, 700, 699),
    "recurrentgemma_wrapped": (4, 2048, 10, 1, 256, 2048, None, 5000),
    "musicgen_mha_d64": (4, 600, 24, 24, 64, 0, 600, 599),
    "g20_short": (2, 40, 20, 1, 64, 0, 25, 24),
}
# one bf16 ulp of the output (2^-7 of it) plus a small absolute term for
# float32 summation order near zero
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-4


def _ring(size, fill, pos, device="cpu"):
    """The positions a ring of ``size`` slots holds: slots ``[0, fill)``
    hold their own index (the rest -1); ``fill=None``, a ring that has
    wrapped at ``pos``: each slot the last position <= ``pos`` it took."""
    s = torch.arange(size, device=device)
    if fill is None:
        return pos - (pos - s) % size
    return torch.where(s < fill, s, -1)


def _inputs(case, dtype, device="cpu", seed=0):
    b, size, h, kh, d, window, fill, pos = case
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *sh: torch.randn(sh, generator=g, device=device).to(dtype)
    q, k, v = rn(b, 1, h, d), rn(b, size, kh, d), rn(b, size, kh, d)
    return (q, k, v, _ring(size, fill, pos, device),
            torch.tensor(pos, device=device), window)


def _plain_path(q, k, v, slot_pos, pos, window, scale):
    """The model's plain decode attention as ``decode_step`` runs it."""
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    h = q.shape[2]
    return attention._sdpa(q, attention._expand_kv(k, h),
                           attention._expand_kv(v, h),
                           valid[None, None, None, :], scale)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_is_the_plain_decode_path(case, dtype):
    q, k, v, slot_pos, pos, window = _inputs(CASES[case],
                                             getattr(torch, dtype))
    scale = 1.0 / math.sqrt(q.shape[-1])
    want = _plain_path(q, k, v, slot_pos, pos, window, scale)
    got = dref.decode_attention_ref(q, k, v, slot_pos, pos, window=window,
                                    scale=scale)
    assert torch.equal(got, want)
    if CASES[case][6] is None:               # the ring has wrapped
        assert int(pos) >= 2 * k.shape[1]


def test_wrapper_checks_shapes():
    q, k, v, slot_pos, pos, _ = _inputs(CASES["g6_d128_partial"],
                                        torch.float32)
    bad = {
        "q": (q[:, :, :5], k, v, slot_pos, pos),
        "v": (q, k, v[:, :-1], slot_pos, pos),
        "slot_pos": (q, k, v, slot_pos[:-1], pos),
        "pos": (q, k, v, slot_pos, pos.view(1)),
        "2 tokens": (torch.cat([q, q], 1), k, v, slot_pos, pos),
        "cpu": (q, k, v, slot_pos, pos),
    }
    n = dk.decode_attention.launches
    for what, args in bad.items():
        with pytest.raises(ValueError, match="shape|group|must be|CUDA"):
            dk.decode_attention(*args)
    assert dk.decode_attention.launches == n


@pytest.mark.parametrize("blocks,t,n_sm,want", [
    (64, 4617, 132, (5, 15)),       # mixtral-8x22b's decode: 8 rows x 8 KV
    (8, 1100, 132, (18, 1)),        # one tile a split: 18 tiles
    (1024, 4617, 132, (1, 73)),     # enough blocks without a split
    (2, 5, 132, (1, 1)),
])
def test_splits_cover_the_keys(blocks, t, n_sm, want):
    splits, per = dk.splits_for(blocks, t, n_sm)
    tiles = -(-t // dk.TILE)
    assert (splits, per) == want
    assert (splits - 1) * per < tiles <= splits * per


# ------------------------------------------------------------ the model
def _model(name, device="cpu", dtype=None):
    cfg = get_tiny_config(name)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    return cfg, T.init(torch.Generator().manual_seed(0), cfg, device)


def _layer(model, cfg, mixer):
    i = next(i for i, (m, _) in enumerate(cfg.layer_specs) if m == mixer)
    return model.layers[i].mixer


def _prefilled(params, cfg, mixer, prompt, steps, device="cpu", b=3):
    g = torch.Generator().manual_seed(1)
    x0 = torch.randn(b, prompt, cfg.d_model, generator=g).to(device)
    positions = torch.arange(prompt, device=device)[None].expand(b, prompt)
    if cfg.mrope_sections is not None:
        positions = positions[:, None].expand(b, 3, prompt)
    _, cache = attention.prefill(params, cfg, x0.to(params.wq.dtype),
                                 positions, max_seq=prompt + steps + 1,
                                 mixer=mixer, impl="naive")
    xs = [torch.randn(b, 1, cfg.d_model, generator=g).to(device,
                                                         params.wq.dtype)
          for _ in range(steps)]
    return cache, xs


def _step_with_ref(params, cfg, x, pos, cache, mixer):
    """``decode_step`` written out with the plain version's attention."""
    b = x.shape[0]
    shape = (b, 3, 1) if cfg.mrope_sections is not None else (b, 1)
    q, k_new, v_new = attention._project_qkv(params, cfg, x,
                                             pos.expand(shape))
    slot = (pos % cache["k"].shape[1]).view(1)
    cache["k"].index_copy_(1, slot, k_new)
    cache["v"].index_copy_(1, slot, v_new)
    cache["pos"].index_copy_(0, slot, pos.view(1))
    out = dref.decode_attention_ref(
        q, cache["k"], cache["v"], cache["pos"], pos,
        window=cfg.window if mixer == "local" else 0,
        scale=1.0 / math.sqrt(cfg.resolved_head_dim))
    return attention._out_proj(params, out)


MODEL_CASES = [
    ("gemma-2b", "attn", 20),               # MQA
    ("recurrentgemma-2b", "local", 60),     # window 64: the ring wraps
    ("qwen2-vl-72b", "attn", 20),           # M-RoPE, positions (B, 3, 1)
    ("mixtral-8x22b", "local", 20),
    ("musicgen-medium", "attn", 20),        # MHA
]


@pytest.mark.parametrize("name,mixer,prompt", MODEL_CASES)
def test_decode_step_on_the_cpu_is_the_plain_version(name, mixer, prompt,
                                                     monkeypatch):
    cfg, model = _model(name, dtype="float32")
    params = _layer(model, cfg, mixer)
    cache, xs = _prefilled(params, cfg, mixer, prompt, 12)
    mine = {k: v.clone() for k, v in cache.items()}
    monkeypatch.setattr(attention.da_ops, "decode_attention", None)
    n = dk.decode_attention.launches
    pos = torch.tensor(prompt)
    for x in xs:
        want = _step_with_ref(params, cfg, x, pos, mine, mixer)
        got, _ = attention.decode_step(params, cfg, x, pos, cache,
                                       mixer=mixer)
        assert torch.equal(got, want)
        for key in cache:
            assert torch.equal(cache[key], mine[key]), key
        pos += 1
    assert dk.decode_attention.launches == n


@pytest.mark.parametrize("name,mixer,prompt", MODEL_CASES[:3])
def test_a_score_hook_keeps_the_plain_path(name, mixer, prompt):
    cfg, model = _model(name, dtype="float32")
    params = _layer(model, cfg, mixer)
    cache, xs = _prefilled(params, cfg, mixer, prompt, 3)
    mine = {k: v.clone() for k, v in cache.items()}
    seen = []
    attention.set_score_constrain(lambda s, what: seen.append(what) or s)
    try:
        pos = torch.tensor(prompt)
        for x in xs:
            want = _step_with_ref(params, cfg, x, pos, mine, mixer)
            got, _ = attention.decode_step(params, cfg, x, pos, cache,
                                           mixer=mixer)
            assert torch.equal(got, want)
            pos += 1
    finally:
        attention.set_score_constrain(None)
    assert seen == ["attn_scores"] * len(xs)


def _replicated(mesh, params, cache, x):
    rep = lambda t: distribute_tensor(t, mesh, [Replicate()])
    return (Params(**{k: rep(v.data) for k, v in params.named_parameters()}),
            {k: rep(v) for k, v in cache.items()}, rep(x))


def _dtensor_step(device, params, cfg, x, pos, cache, mixer):
    """One decode step on a one-rank fake mesh of ``device``, every
    operand a replicated DTensor; returns the local output and cache."""
    with dryrun.fake_world(1):
        mesh = init_device_mesh(device, (1,))
        dp, dc, dx = _replicated(mesh, params, cache, x)
        with implicit_replication():
            got, back = attention.decode_step(dp, cfg, dx, pos, dc,
                                              mixer=mixer)
        assert isinstance(got, DTensor)
        return got.to_local(), {k: v.to_local() for k, v in back.items()}


def test_a_dtensor_keeps_the_plain_path_on_the_cpu():
    cfg, model = _model("llama3-8b", dtype="float32")
    params = _layer(model, cfg, "attn")
    cache, (x,) = _prefilled(params, cfg, "attn", 8, 1)
    mine = {k: v.clone() for k, v in cache.items()}
    pos = torch.tensor(8)
    want = _step_with_ref(params, cfg, x, pos, mine, "attn")
    n = dk.decode_attention.launches
    got, back = _dtensor_step("cpu", params, cfg, x, pos, cache, "attn")
    assert torch.equal(got, want)
    for key in mine:
        assert torch.equal(back[key], mine[key]), key
    assert dk.decode_attention.launches == n


# --------------------------------------------------------------- a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_float32_plain_version(cuda_device, case):
    """The kernel against the plain version in float32 (q, k and v cast
    up, the same mask): within one bf16 ulp of the output and no further
    off than the plain bf16 path; every other split of the keys within
    one bf16 ulp of the default split's output (the merge's order moves
    the float32 sums, and the output's rounding with them)."""
    q, k, v, slot_pos, pos, window = _inputs(CARD_CASES[case],
                                             torch.bfloat16, cuda_device)
    scale = 1.0 / math.sqrt(q.shape[-1])
    n = dk.decode_attention.launches
    got = dk.decode_attention(q, k, v, slot_pos, pos, window=window)
    assert dk.decode_attention.launches == n + 1
    want32 = dref.decode_attention_ref(q.float(), k.float(), v.float(),
                                       slot_pos, pos, window=window,
                                       scale=scale)
    plain = dref.decode_attention_ref(q, k, v, slot_pos, pos, window=window,
                                      scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want32).abs()
    plain_err = float((plain.float() - want32).abs().max())
    assert bool((err <= BF16_ULP_ATOL + BF16_ULP_RTOL * want32.abs()).all()), \
        float(err.max())
    assert float(err.max()) <= plain_err, (float(err.max()), plain_err)
    tiles = -(-k.shape[1] // dk.TILE)
    for splits in (1, 3, tiles):
        per = -(-tiles // splits)
        other = dk._launch(q, k, v, slot_pos, pos, window, scale,
                           -(-tiles // per), per)
        torch.testing.assert_close(other.float(), got.float(), rtol=2 ** -7,
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "head_dim", "strides"])
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, case):
    q, k, v, slot_pos, pos, _ = _inputs((2, 64, 4, 2, 128, 0, 10, 9),
                                        torch.bfloat16, cuda_device)
    if case == "dtype":
        args, match = (q.half(), k.half(), v.half()), "dtype"
    elif case == "head_dim":
        args, match = (q[..., :96], k[..., :96].contiguous(),
                       v[..., :96].contiguous()), "head_dim"
    else:                                   # k 8 bytes off its alignment
        base = torch.empty(k.numel() + 8, dtype=k.dtype, device=k.device)
        args, match = (q, base[4:4 + k.numel()].view(k.shape), v), "aligned"
    with pytest.raises(ValueError, match=match):
        dk.decode_attention(*args, slot_pos, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mixer,prompt", [
    ("gemma-2b", "attn", 20), ("recurrentgemma-2b", "local", 60)])
def test_captured_decode_step_replays_its_eager_steps(cuda_device, name,
                                                      mixer, prompt):
    """An attention layer's decode step captured once as a CUDA graph and
    replayed as the position moves (recurrentgemma's ring wraps): every
    replay's output and cache equal the eager step's bitwise."""
    cfg, model = _model(name, cuda_device)
    params = _layer(model, cfg, mixer)
    steps = 12
    cache, xs = _prefilled(params, cfg, mixer, prompt, steps, cuda_device)
    eager = {k: v.clone() for k, v in cache.items()}
    x_in = xs[0].clone()
    pos = torch.tensor(prompt, device=cuda_device)
    # one eager step on the capture's stream, then the capture
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    warm = {k: v.clone() for k, v in cache.items()}
    with torch.cuda.stream(side):
        attention.decode_step(params, cfg, x_in, pos, warm, mixer=mixer)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        y, _ = attention.decode_step(params, cfg, x_in, pos, cache,
                                     mixer=mixer)
    p = prompt
    for x in xs:
        x_in.copy_(x)
        pos.fill_(p)
        graph.replay()
        want, _ = attention.decode_step(params, cfg, x, torch.tensor(
            p, device=cuda_device), eager, mixer=mixer)
        torch.cuda.synchronize()
        assert torch.equal(y, want), p
        for key in eager:
            assert torch.equal(cache[key], eager[key]), (p, key)
        p += 1
    assert prompt + steps > (cfg.window if mixer == "local" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mixer,prompt", MODEL_CASES)
def test_decode_step_on_the_card_never_expands_the_cache(
        cuda_device, name, mixer, prompt, monkeypatch):
    """On the card ``decode_step`` attends through the kernel (one launch a
    step, ``_expand_kv`` never called), close to the plain path on the
    same cache; with a score hook set, or (gemma-2b) on a DTensor of a
    one-rank fake mesh, it takes the plain path and launches nothing."""
    cfg, model = _model(name, cuda_device)
    params = _layer(model, cfg, mixer)
    cache, xs = _prefilled(params, cfg, mixer, prompt, 3, cuda_device)
    real_expand = attention._expand_kv

    def refuse(*_):
        raise AssertionError("the cache was expanded on the card")

    monkeypatch.setattr(attention, "_expand_kv", refuse)
    pos = torch.tensor(prompt, device=cuda_device)
    for x in xs:
        n = dk.decode_attention.launches
        got, _ = attention.decode_step(params, cfg, x, pos, cache,
                                       mixer=mixer)
        assert dk.decode_attention.launches == n + 1
        pos += 1
    monkeypatch.setattr(attention, "_expand_kv", real_expand)
    x = xs[-1]
    mine = {k: v.clone() for k, v in cache.items()}
    attention.set_score_constrain(lambda s, what: s)
    try:
        n = dk.decode_attention.launches
        hooked, _ = attention.decode_step(params, cfg, x, pos, cache,
                                          mixer=mixer)
        assert dk.decode_attention.launches == n
    finally:
        attention.set_score_constrain(None)
    got, _ = attention.decode_step(params, cfg, x, pos, mine, mixer=mixer)
    torch.testing.assert_close(got.float(), hooked.float(), rtol=2 ** -6,
                               atol=2e-2 * float(hooked.abs().max()))
    if name == "gemma-2b":
        n = dk.decode_attention.launches
        local, _ = _dtensor_step("cuda", params, cfg, x, pos, mine, mixer)
        assert dk.decode_attention.launches == n
        torch.testing.assert_close(local, hooked, rtol=0, atol=0)


@pytest.mark.cuda
def test_mixtral_tiny_serves_the_same_tokens_with_the_kernel(cuda_device,
                                                             monkeypatch):
    """Mixtral-tiny served on the card twice: its decode through the
    plain path (a score hook that changes nothing keeps it there), then
    through the kernel with every MoE call routed as in the plain run
    (recorded there, replayed here: an expert's choice flips at
    near-equal router scores, which no two attention paths can hold to).
    Each row's served tokens are equal, or part at a step where the plain
    path's chosen logit lies within twice that step's gap between the runs
    of the kernel path's choice (a tie of bf16 logits); every step fed the
    same tokens has logits within 3e-2 of the largest of both runs."""
    from test_torch_decode_graph import (STEPS, U, _recorded_decode, _serve,
                                         _split, _tokens)
    from repro_torch.models import moe
    cfg, model = _model("mixtral-8x22b", cuda_device)
    toks, split, prompt = _tokens(cfg, 64, 9), _split(cfg, "split0"), 64
    real_route, routes = moe._route, []

    def recording(router, cfg_, x):
        out = real_route(router, cfg_, x)
        routes.append(out[0])
        return out

    def replaying(router, cfg_, x):
        _, _, me, ce = real_route(router, cfg_, x)
        idx = routes.pop(0)
        probs = torch.softmax(torch.matmul(x.float(), router), dim=-1)
        gate = probs.gather(-1, idx)
        return idx, gate / torch.clamp_min(gate.sum(-1, keepdim=True),
                                           1e-9), me, ce

    runs = {}
    for mode, route in (("plain", recording), ("kernel", replaying)):
        rec = torch.zeros((U, prompt + STEPS + 1, cfg.padded_vocab),
                          device=cuda_device)
        monkeypatch.setattr(T, "decode_step", _recorded_decode(rec))
        monkeypatch.setattr(moe, "_route", route)
        if mode == "plain":
            attention.set_score_constrain(lambda s, what: s)
        n = dk.decode_attention.launches
        try:
            served = np.stack([r.tokens_out
                               for r in _serve(model, cfg, split, toks)])
        finally:
            attention.set_score_constrain(None)
        runs[mode] = (served, rec[:, prompt:prompt + STEPS - 1].clone(),
                      dk.decode_attention.launches - n)
    (tk, lk, nk), (tp, lp, n_plain) = runs["kernel"], runs["plain"]
    n_attn = sum(m in ("attn", "local") for m, _ in cfg.layer_specs)
    assert (nk, n_plain) == ((STEPS - 1) * n_attn, 0)
    assert not routes
    bar = 3e-2 * max(float(lp.abs().max()), float(lk.abs().max()))
    for u in range(U):
        parted = np.nonzero(tk[u] != tp[u])[0]
        j = int(parted[0]) if len(parted) else STEPS
        gaps = [float((lk[u, i] - lp[u, i]).abs().max())
                for i in range(min(j, STEPS - 1))]
        assert max(gaps) <= bar, (u, gaps, bar)
        if j < STEPS:                  # step j - 1 chose token j
            margin = float(lp[u, j - 1, tp[u, j]] - lp[u, j - 1, tk[u, j]])
            assert margin <= 2 * gaps[j - 1], (u, j, margin, gaps[j - 1])
