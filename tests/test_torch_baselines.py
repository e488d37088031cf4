"""The paper's baselines in the port (``repro_torch.core.baselines``)
against the JAX package's on the CPU, on one seeded (24, 8) cell with the
yolov2 profile and a 0.4 s threshold, the fixture of the JAX package's
``test_era_core.py``.

  * Device-Only, Edge-Only, Neurosurgeon and DINA compute no GD: their
    splits and one-hot β equal JAX's exactly, the other allocation leaves
    and every ``Terms`` field within rtol 1e-5.
  * DNN-Surgery and IAO run GD: the port's ``fused`` step is held to JAX's
    ``fused`` and its ``autograd`` to JAX's ``xla``, with exact splits and
    the bar of ``test_torch_ligd.py`` (``port_bridge.spread_bar``: 1e-5,
    widened to twice JAX's own xla-vs-fused spread where that is larger).
    JAX's baselines take their GD step from ``ligd._gd_solve`` and
    ``ligd.solve``'s defaults; its ``fused`` variants are those two with
    ``step_impl='fused'``, patched in for the duration of a fixture.
  * ERA beats every baseline on Γ within the 1.15 factor of
    ``test_era_core.py``, and the paper's Figs. 6–9 directions hold
    (``test_system.py``).
  * Ties in latency or bits go to the lower split index, as
    ``jnp.argmin`` breaks them.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_bridge as pb
from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)
from repro.core import baselines as jbase
from repro.core import ligd as jligd
from repro.core import network as jnet
from repro.core import profiles as jprof
from repro_torch.core import baselines, era, ligd

U, M = 24, 8
NON_GD = ("device_only", "edge_only", "neurosurgeon", "dina")
GD = ("dnn_surgery", "iao")
IMPLS = {"fused": "fused", "autograd": "xla"}
RTOL = 1e-5


@pytest.fixture(scope="module")
def cell():
    jscn = jnet.make_scenario(jax.random.PRNGKey(0),
                              jnet.small_config(n_users=U, n_subchannels=M))
    jp = jprof.get_profile("yolov2")
    return jscn, jp, pb.scenario(jscn), pb.profile(jp)


@pytest.fixture(scope="module")
def jax_outs(cell):
    """JAX's run_all with its own GD step (xla), and its GD baselines
    again with the fused step."""
    jscn, jp, _, _ = cell
    q = jnp.full((U,), 0.4)
    outs = {"xla": jbase.run_all(jscn, jp, q)}
    orig_solve = jligd.solve

    def fused_solve(scn, prof, q, w, lr, max_steps):
        return orig_solve(scn, prof, q, w, spec=jligd.SolverSpec(
            lr=lr, max_steps=max_steps, step_impl="fused"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbase, "_gd_solve",
                   functools.partial(jligd._gd_solve, step_impl="fused"))
        mp.setattr(jligd, "solve", fused_solve)
        outs["fused"] = {name: jbase.ALL_BASELINES[name](jscn, jp, q)
                         for name in GD}
    return outs


@pytest.fixture(scope="module")
def port_outs(cell):
    _, _, scn, prof = cell
    q = torch.full((U,), 0.4)
    outs = {"fused": baselines.run_all(scn, prof, q)}
    outs["autograd"] = {
        name: baselines.ALL_BASELINES[name](scn, prof, q,
                                            step_impl="autograd")
        for name in GD}
    return outs


def _assert_terms_close(got, want):
    for name, g, w in zip(era.Terms._fields, got, want):
        np.testing.assert_allclose(pb.to_np(g), np.asarray(w), rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("name", NON_GD)
def test_non_gd_baseline_matches_jax(jax_outs, port_outs, name):
    got, want = port_outs["fused"][name], jax_outs["xla"][name]
    assert got.name == want.name == name
    np.testing.assert_array_equal(got.s, np.asarray(want.s))
    for leaf, g, w in zip(era.Allocation._fields, got.alloc, want.alloc):
        if leaf.startswith("beta"):
            np.testing.assert_array_equal(pb.to_np(g), np.asarray(w),
                                          err_msg=leaf)
        else:
            np.testing.assert_allclose(pb.to_np(g), np.asarray(w),
                                       rtol=RTOL, err_msg=leaf)
    _assert_terms_close(got.terms, want.terms)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", GD)
def test_gd_baseline_matches_jax(jax_outs, port_outs, name, impl):
    """Port ``fused`` against JAX ``fused``, port ``autograd`` against JAX
    ``xla``; JAX's other step kind gives the spread."""
    jimpl = IMPLS[impl]
    other_impl = "xla" if jimpl == "fused" else "fused"
    got = port_outs[impl][name]
    want = (jax_outs[jimpl] if jimpl == "fused" else jax_outs["xla"])[name]
    other = (jax_outs[other_impl] if other_impl == "fused"
             else jax_outs["xla"])[name]
    np.testing.assert_array_equal(got.s, np.asarray(want.s))
    pb.assert_within_spread(got.terms.gamma, want.terms.gamma,
                            other.terms.gamma, abs(float(want.terms.gamma)),
                            f"{name} gamma")
    pb.assert_within_spread(got.terms.t, want.terms.t, other.terms.t,
                            np.max(np.abs(np.asarray(want.terms.t))),
                            f"{name} t", whole=True)
    for leaf, g, w, o in zip(era.Allocation._fields, got.alloc, want.alloc,
                             other.alloc):
        if leaf.startswith("beta"):
            np.testing.assert_array_equal(pb.to_np(g), np.asarray(w),
                                          err_msg=leaf)
        else:
            pb.assert_within_spread(g, w, o, np.max(np.abs(np.asarray(w))),
                                    f"{name} {leaf}", whole=True)


@pytest.mark.parametrize("name", GD)
def test_gd_baseline_fused_step_equals_autograd(port_outs, name):
    """The port's two step kinds agree on the GD baselines by the solver's
    bar (``chip_smoke.py`` phase 5): equal splits and GD iterations, Γ
    within rtol 1e-4."""
    x, y = port_outs["fused"][name], port_outs["autograd"][name]
    np.testing.assert_array_equal(x.s, y.s)
    assert x.iters == y.iters > 0
    np.testing.assert_allclose(float(x.terms.gamma), float(y.terms.gamma),
                               rtol=1e-4)


@pytest.fixture(scope="module")
def era_out(cell):
    _, _, scn, prof = cell
    return ligd.solve(scn, prof, torch.full((U,), 0.4),
                      spec=ligd.SolverSpec(max_steps=300))


def test_baselines_structure(cell, port_outs, era_out):
    """``test_era_core.py``'s bar: Device-Only at F, Edge-Only's feasible
    users at 0, every Γ finite, and no baseline beats ERA's Γ by more
    than the 1.15 factor."""
    _, _, _, prof = cell
    outs = port_outs["fused"]
    assert (outs["device_only"].s == prof.n_layers).all()
    edge = outs["edge_only"].s
    assert (edge[edge != prof.n_layers] == 0).all()
    for name, o in outs.items():
        assert np.isfinite(float(o.terms.gamma)), name
        assert float(era_out.terms.gamma) <= float(o.terms.gamma) * 1.15, \
            name


@pytest.fixture(scope="module")
def era_200(cell):
    """ERA at ``test_system.py``'s 200-step budget."""
    _, _, scn, prof = cell
    return ligd.solve(scn, prof, torch.full((U,), 0.4),
                      spec=ligd.SolverSpec(max_steps=200))


def test_era_beats_device_only_latency(port_outs, era_200):
    """Fig. 6 direction: ERA's latency speedup over Device-Only ≫ 1."""
    dev = port_outs["fused"]["device_only"]
    assert float(dev.terms.t.mean()) / float(era_200.terms.t.mean()) > 2.0


def test_era_saves_energy_vs_edge_only(port_outs, era_200):
    """Fig. 7 direction: ERA's energy ≪ Edge-Only's."""
    edge = port_outs["fused"]["edge_only"]
    assert float(era_200.terms.e.mean()) < float(edge.terms.e.mean())


def test_qoe_relaxation_saves_energy(cell):
    """Figs. 8/9 direction: relaxing the QoE threshold lowers energy."""
    _, _, scn, prof = cell
    tight, loose = (ligd.solve(scn, prof, torch.full((U,), q_s),
                               spec=ligd.SolverSpec(max_steps=200))
                    for q_s in (0.15, 0.6))
    assert float(loose.terms.e.sum()) <= float(tight.terms.e.sum()) * 1.05


def _variant(jp, flops, bits):
    jv = jprof.SplitProfile(jp.name, jnp.asarray(flops), jnp.asarray(bits),
                            jp.input_bits, jp.result_bits)
    return jv, pb.profile(jv)


def test_ties_take_the_lower_split(cell):
    """Neurosurgeon: a zero-FLOP first layer that passes the input on
    unchanged gives splits 0 and 1 identical latency for every user.
    DINA: a layer that repeats its predecessor's minimal output gives two
    equal minima of the uplink bits.  Both take the lower split, as
    ``jnp.argmin`` does, and equal JAX's picks."""
    jscn, jp, scn, _ = cell
    flops = np.asarray(jp.layer_flops, np.float32).copy()
    bits = np.asarray(jp.out_bits, np.float32).copy()
    q, jq = torch.full((U,), 0.4), jnp.full((U,), 0.4)

    f0, b0 = flops.copy(), bits.copy()
    f0[0], b0[0] = 0.0, jp.input_bits
    jv, v = _variant(jp, f0, b0)
    table = baselines._latency_table(scn, v,
                                     baselines.default_alloc(scn)).numpy()
    assert np.array_equal(table[0], table[1])
    got = baselines.neurosurgeon(scn, v, q)
    np.testing.assert_array_equal(
        got.s, np.asarray(jbase.neurosurgeon(jscn, jv, jq).s))
    assert (got.s == 0).any() and not (got.s == 1).any()

    k = int(np.argmin(bits[:-2]))
    b1 = bits.copy()
    b1[k + 1] = b1[k]
    jv, v = _variant(jp, flops, b1)
    up = v.uplink_bits[:-1].numpy()
    assert up[k + 1] == up[k + 2] == up.min()
    got = baselines.dina(scn, v, q)
    np.testing.assert_array_equal(got.s,
                                  np.asarray(jbase.dina(jscn, jv, jq).s))
    assert (got.s[got.s != v.n_layers] == k + 1).all()
