"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) against
the JAX package's ``models/moe.py`` on the CPU, in float32: capacity,
routing (top-k ties included), slot order and drops, dispatch groups and
the chunked expert loop.  Weights come from the JAX ``init`` and cross
over through ``interop``; inputs are made with numpy from a seed."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro_torch import configs, interop
from repro_torch.models import moe
from repro_torch.models import transformer as T

CPU = "cpu"
FAMILIES = ["mixtral-8x22b", "dbrx-132b"]
SEQ = 96


def _cfgs(name, **kw):
    jcfg = jconfigs.get_tiny_config(name).replace(dtype="float32", **kw)
    cfg = configs.get_tiny_config(name).replace(dtype="float32", **kw)
    return jcfg, cfg


def _case(name, seed=0, **kw):
    """The FFN's JAX params, the port's copy and a (2, SEQ, d) input."""
    jcfg, cfg = _cfgs(name, **kw)
    jp = jmoe.init(jax.random.PRNGKey(seed), jcfg)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(seed + 1).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _jax_slots(idx, cap):
    """JAX's token-major slot order, exclusive position-in-expert and keep
    mask, recomputed with numpy from its expert indices (G, T, k)."""
    flat_e = np.asarray(idx).reshape(idx.shape[0], -1)
    pos = np.zeros_like(flat_e)
    for g in range(flat_e.shape[0]):
        seen = {}
        for j, e in enumerate(flat_e[g]):
            pos[g, j] = seen.get(int(e), 0)
            seen[int(e)] = pos[g, j] + 1
    return flat_e, pos, pos < cap


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30)


# ---------------------------------------------------------------- capacity
@pytest.mark.parametrize("chunk", [8192, 16])
def test_capacity_matches_jax(monkeypatch, chunk):
    monkeypatch.setattr(jmoe, "C_CHUNK", chunk)
    monkeypatch.setattr(moe, "C_CHUNK", chunk)
    for name in FAMILIES:
        base_j, base = _cfgs(name)
        for e, k in ((4, 1), (4, 2), (8, 2), (16, 4)):
            for cf in (0.3, 1.0, 1.25, 2.0):
                jcfg = base_j.replace(n_experts=e, top_k=k,
                                      capacity_factor=cf)
                cfg = base.replace(n_experts=e, top_k=k, capacity_factor=cf)
                for t in (1, 7, 8, 96, 192, 1000, 36_864, 73_728):
                    assert moe.capacity(cfg, t) == jmoe.capacity(jcfg, t), \
                        (e, k, cf, t)


def test_capacity_of_the_card_prefill_takes_the_chunked_loop():
    """mixtral-8x22b: a group of 8 x 4608 tokens has capacity 11,520,
    rounded up to two chunks; one decode token per user caps at top_k."""
    cfg = configs.get_config("mixtral-8x22b")
    assert moe.capacity(cfg, 8 * 4608) == 2 * moe.C_CHUNK == 16_384
    assert moe.capacity(cfg, 8) == 2


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("name", FAMILIES)
def test_route_matches_jax(name):
    jcfg, cfg, jp, p, x = _case(name)
    xg = x.reshape(2, SEQ, -1)
    jidx, jgate, jaux = jmoe.route(jp, jcfg, xg)
    idx, gate, aux = moe.route(p, cfg, torch.as_tensor(xg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    assert gate.dtype == torch.float32


def test_route_breaks_ties_like_jax():
    """Two equal router columns: every token's two probabilities tie, and
    top-k takes the lower expert index first, as ``jax.lax.top_k``."""
    jcfg, cfg, jp, p, x = _case("mixtral-8x22b")
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=router)
    p.router.data.copy_(torch.as_tensor(router))
    jidx, jgate, jaux = jmoe.route(jp, jcfg, x)
    idx, gate, aux = moe.route(p, cfg, torch.as_tensor(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    # the tie bites: some token has both tied experts in its top 2
    both = (idx == 1).any(-1) & (idx == 3).any(-1)
    assert bool(both.any())
    assert not bool(((idx[..., 0] == 3) & (idx[..., 1] == 1)).any())
    y, _ = moe.forward(p, cfg, torch.as_tensor(x))
    jy, _ = jmoe.forward(jp, jcfg, x)
    assert _scaled_err(y.numpy(), jy) <= 1e-5


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("groups", [1, 2, 5], ids=["g1", "g2", "g5-falls-back"])
@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name, groups):
    """y within 1e-5 of max |y|, aux within 1e-5, and the port's slots
    (expert, position, keep) equal to JAX's order on its own routes.
    5 does not divide the 192 tokens, so it falls back to one group."""
    jcfg, cfg, jp, p, x = _case(name, moe_dispatch_groups=groups)
    jy, jaux = jmoe.forward(jp, jcfg, x)
    y, aux = moe.forward(p, cfg, torch.as_tensor(x))
    assert _scaled_err(y.numpy(), jy) <= 1e-5
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    g = moe.groups(cfg, 2 * SEQ)
    assert g == (groups if (2 * SEQ) % groups == 0 else 1)
    tl = 2 * SEQ // g
    cap = moe.capacity(cfg, tl)
    xg = x.reshape(g, tl, -1)
    jidx, _, _ = jmoe.route(jp, jcfg, xg)
    idx, _, _ = moe.route(p, cfg, torch.as_tensor(xg))
    want = _jax_slots(jidx, cap)
    for got, w in zip(moe.slots(cfg, idx, cap), want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_drops_tokens_past_capacity(name):
    """A small capacity factor drops slots (no zeroed router: that would
    tie every probability); the dropped slots add zero in both."""
    jcfg, cfg, jp, p, x = _case(name, capacity_factor=0.3)
    idx, _, _ = moe.route(p, cfg, torch.as_tensor(x.reshape(1, 2 * SEQ, -1)))
    cap = moe.capacity(cfg, 2 * SEQ)
    _, _, keep = moe.slots(cfg, idx, cap)
    assert 0.2 < float(keep.float().mean()) < 0.9
    jy, jaux = jmoe.forward(jp, jcfg, x)
    y, aux = moe.forward(p, cfg, torch.as_tensor(x))
    assert _scaled_err(y.numpy(), jy) <= 1e-5
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
    # a token whose every slot was dropped comes out exactly zero
    dropped = ~keep.reshape(2 * SEQ, cfg.top_k).any(-1)
    assert bool(dropped.any())
    assert bool((y.reshape(2 * SEQ, -1)[dropped] == 0).all())


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_chunked_expert_loop_matches_jax(monkeypatch, name):
    """C_CHUNK = 16 in both modules: capacity 120 rounds up to 128 and the
    expert FFN runs over 8 capacity chunks."""
    monkeypatch.setattr(jmoe, "C_CHUNK", 16)
    monkeypatch.setattr(moe, "C_CHUNK", 16)
    jcfg, cfg, jp, p, x = _case(name)
    cap = moe.capacity(cfg, 2 * SEQ)
    assert cap > moe.C_CHUNK and cap % moe.C_CHUNK == 0
    calls = []
    ffn = moe._expert_ffn

    def spy(params, cfg_, block):
        calls.append(tuple(block.shape))
        return ffn(params, cfg_, block)

    monkeypatch.setattr(moe, "_expert_ffn", spy)
    jy, _ = jmoe.forward(jp, jcfg, x)
    y, _ = moe.forward(p, cfg, torch.as_tensor(x))
    assert len(calls) == cap // 16 and calls[0][2] == 16
    assert _scaled_err(y.numpy(), jy) <= 1e-5


def test_forward_is_deterministic():
    _, cfg, _, p, x = _case("dbrx-132b", capacity_factor=0.5)
    a, _ = moe.forward(p, cfg, torch.as_tensor(x))
    b, _ = moe.forward(p, cfg, torch.as_tensor(x))
    assert torch.equal(a, b)


# -------------------------------------------------------------- weights
@pytest.mark.parametrize("name", FAMILIES)
def test_init_layout_matches_jax(name):
    """The port's init has JAX's names, shapes and dtypes (bf16 experts,
    a float32 router), with truncated-normal fan-in scales."""
    jcfg = jconfigs.get_tiny_config(name)
    cfg = configs.get_tiny_config(name)
    jp = jmoe.init(jax.random.PRNGKey(0), jcfg)
    p = moe.init(torch.Generator().manual_seed(0), cfg, CPU)
    got = {n: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for n, v in p.named_parameters()}
    want = {n: (tuple(v.shape), str(v.dtype)) for n, v in jp.items()}
    assert got == want
    assert p.router.dtype == torch.float32
    std = 1.0 / np.sqrt(cfg.d_ff)
    assert float(p.w_out.float().abs().max()) <= 2.0 * std * (1 + 1e-2)


@pytest.mark.parametrize("name", FAMILIES)
def test_model_from_numpy_keeps_moe_dtypes(name):
    """The router crosses over in float32 and the experts in the model's
    bf16, bit for bit."""
    jcfg = jconfigs.get_tiny_config(name)
    cfg = configs.get_tiny_config(name)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device=CPU)
    ffn = model.layers[1].ffn
    jffn = jax.tree.map(lambda v: np.asarray(v)[1],
                        jparams["units"][0]["ffn"])
    assert ffn.router.dtype == torch.float32
    np.testing.assert_array_equal(ffn.router.numpy(), jffn["router"])
    for w in ("w_in", "w_gate", "w_out"):
        assert getattr(ffn, w).dtype == torch.bfloat16, w
        np.testing.assert_array_equal(getattr(ffn, w).float().numpy(),
                                      jffn[w].astype(np.float32))
    fresh = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    assert {n: (x.dtype, tuple(x.shape)) for n, x in model.named_parameters()} \
        == {n: (x.dtype, tuple(x.shape)) for n, x in fresh.named_parameters()}


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_forward_near_jax(name):
    """In the model's bf16 the port's FFN stays within a few bf16 ulps of
    JAX's on the same weights and input (routes compared on the same
    float32 router logits)."""
    jcfg = jconfigs.get_tiny_config(name)
    cfg = configs.get_tiny_config(name)
    jp = jmoe.init(jax.random.PRNGKey(0), jcfg)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    x = np.random.default_rng(3).standard_normal(
        (2, SEQ, cfg.d_model)).astype(np.float32)
    xb = jax.numpy.asarray(x, jax.numpy.bfloat16)
    jy, jaux = jmoe.forward(jp, jcfg, xb)
    y, aux = moe.forward(p, cfg, torch.as_tensor(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert _scaled_err(y.float().numpy(), np.asarray(jy, np.float32)) <= 2e-2
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5)
