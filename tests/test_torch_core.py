"""The port's core forward path (``repro_torch.core``) against the JAX
package on the CPU: scenarios, orderings, NOMA rates, the ERA utility and
its autograd gradient.  Inputs are built by JAX from seeds and carried
across through numpy (``repro_torch.interop``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_bridge as pb
from repro.core import era as jera
from repro.core import network as jnet
from repro.core import noma as jnoma
from repro.core import profiles as jprof
from repro_torch.core import era, network, noma, profiles

SIZES = [(12, 6), (8, 4)]


def _alloc(u, m, seed, lead=()):
    ks = jax.random.split(jax.random.PRNGKey(100 + seed), 5)
    return jera.Allocation(
        beta_up=jax.nn.softmax(jax.random.normal(ks[0], lead + (u, m)), -1),
        beta_dn=jax.nn.softmax(jax.random.normal(ks[1], lead + (u, m)), -1),
        p=jnp.exp(jax.random.normal(ks[2], lead + (u,)) * 0.3) * 0.1,
        p_ap=jnp.exp(jax.random.normal(ks[3], lead + (u,)) * 0.3),
        r=1.0 + jnp.exp(jax.random.normal(ks[4], lead + (u,)) * 0.2))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"u{s[0]}m{s[1]}")
def case(request):
    """One JAX cell, its port twin, a random allocation and the JAX-side
    references, built once per size."""
    u, m = request.param
    cfg = jnet.small_config(n_users=u, n_subchannels=m)
    jscn = jnet.make_scenario(jax.random.PRNGKey(u + m), cfg)
    jp = jprof.get_profile("nin")
    ja = _alloc(u, m, seed=u)
    q = jnp.linspace(0.2, 0.6, u)
    s = jnp.asarray(np.arange(u) % (jp.n_layers + 1), jnp.int32)
    jw = jera.Weights()

    def loss(a):
        return jera.utility(jscn, jp, s, a, q, jw).gamma

    ref = dict(
        terms=jera.utility(jscn, jp, s, ja, q, jw),
        grad=jax.grad(loss)(ja),
        up=jnoma.uplink_rates(jscn, ja.beta_up, ja.p),
        dn=jnoma.downlink_rates(jscn, ja.beta_dn, ja.p_ap),
        sic=jnoma.sic_feasible(jscn, ja.beta_up, ja.p))
    port = dict(scn=pb.scenario(jscn), prof=pb.profile(jp),
                alloc=pb.allocation(ja),
                q=torch.as_tensor(np.array(q)),
                s=torch.as_tensor(np.array(s), dtype=torch.int64),
                w=pb.weights(jw))
    return ref, port


def test_utility_terms_match_jax(case):
    ref, pt = case
    got = era.utility(pt["scn"], pt["prof"], pt["s"], pt["alloc"], pt["q"],
                      pt["w"])
    for name, a, b in zip(era.Terms._fields, got, ref["terms"]):
        np.testing.assert_allclose(pb.to_np(a), np.asarray(b), rtol=1e-5,
                                   err_msg=name)


def test_autograd_gradient_matches_jax_grad(case):
    """torch.autograd of Γ against jax.grad, each leaf scaled by its max
    |value| (the bar of the JAX package's ref-vs-autodiff test)."""
    ref, pt = case
    leaves = [x.clone().requires_grad_(True) for x in pt["alloc"]]
    gamma = era.utility(pt["scn"], pt["prof"], pt["s"],
                        era.Allocation(*leaves), pt["q"], pt["w"]).gamma
    grads = torch.autograd.grad(gamma, leaves)
    pb.assert_leaves_close(grads, ref["grad"], atol=1e-4)


def test_noma_rates_and_sic_match_jax(case):
    ref, pt = case
    scn, a = pt["scn"], pt["alloc"]
    np.testing.assert_allclose(
        noma.uplink_rates(scn, a.beta_up, a.p).numpy(), np.asarray(ref["up"]),
        rtol=1e-5)
    np.testing.assert_allclose(
        noma.downlink_rates(scn, a.beta_dn, a.p_ap).numpy(),
        np.asarray(ref["dn"]), rtol=1e-5)
    np.testing.assert_array_equal(
        noma.sic_feasible(scn, a.beta_up, a.p).numpy(), np.asarray(ref["sic"]))


def test_relu_tie_splits_gradient_like_jax():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    noma.relu_tie(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0)))(
        jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def cells():
    """Four JAX cells at (8, 4) and their port twins."""
    cfg = jnet.small_config(n_users=8, n_subchannels=4)
    jscns = [jnet.make_scenario(jax.random.PRNGKey(10 + i), cfg)
             for i in range(4)]
    return jscns, [pb.scenario(s) for s in jscns]


def _assert_scn_equal(got, want):
    for f in ("assoc", "h_up", "h_dn", "up_order", "up_group_end",
              "dn_order", "dn_group_end"):
        np.testing.assert_array_equal(pb.to_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f, a, b in zip(network.CellEnv._fields, got.env, want.env):
        np.testing.assert_allclose(pb.to_np(a), np.asarray(b, np.float32),
                                   err_msg=f)


def test_orderings_equal_jax(cells):
    jscns, _ = cells
    for s in jscns:
        own = np.asarray(s.own_gain_up())
        assoc = np.asarray(s.assoc)
        for desc in (True, False):
            got = network._orderings(own, assoc, desc)
            want = jnet._orderings(own, assoc, desc)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_stack_take_concat_equal_jax(cells):
    jscns, scns = cells
    _assert_scn_equal(network.stack_scenarios(scns),
                      jnet.stack_scenarios(jscns))
    jb, tb = jnet.stack_scenarios(jscns), network.stack_scenarios(scns)
    idx = [2, 0, 2]
    _assert_scn_equal(network.take_cells(tb, idx), jnet.take_cells(jb, idx))
    _assert_scn_equal(
        network.concat_cells(network.take_cells(tb, [1]),
                             network.take_cells(tb, [3])),
        jnet.concat_cells(jnet.take_cells(jb, [1]), jnet.take_cells(jb, [3])))
    assert network.envs_differ(scns) == jnet.envs_differ(jscns) is False


def test_own_gains_equal_jax(cells):
    jscns, scns = cells
    np.testing.assert_array_equal(scns[0].own_gain_up().numpy(),
                                  np.asarray(jscns[0].own_gain_up()))
    np.testing.assert_array_equal(scns[0].own_gain_dn().numpy(),
                                  np.asarray(jscns[0].own_gain_dn()))


def test_scenario_drift_matches_jax(cells):
    jscns, scns = cells
    for i, j in ((0, 1), (2, 3), (1, 1)):
        np.testing.assert_allclose(
            network.scenario_drift(scns[i], scns[j]),
            jnet.scenario_drift(jscns[i], jscns[j]), rtol=1e-5)


def test_profiles_match_jax():
    for name in ("nin", "yolov2", "vgg16"):
        jp, tp = jprof.get_profile(name), profiles.get_profile(name, "cpu")
        for f in ("device_flops", "edge_flops", "uplink_bits",
                  "downlink_bits"):
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)),
                                       rtol=1e-6, err_msg=f"{name}.{f}")
    stacked = profiles.stack_profiles([profiles.get_profile("nin", "cpu")] * 2)
    jst = jprof.stack_profiles([jprof.get_profile("nin")] * 2)
    np.testing.assert_allclose(stacked.uplink_bits.numpy(),
                               np.asarray(jax.vmap(
                                   lambda p: p.uplink_bits)(jst)))


def test_make_scenario_statistics():
    """The port's own generator draws torch's numbers, not jax.random's:
    hold it by construction, not bit for bit."""
    cfg = network.small_config(n_users=40, n_subchannels=8)
    scn = network.make_scenario(torch.Generator().manual_seed(0), cfg, "cpu")
    u, n, m = cfg.n_users, cfg.n_aps, cfg.n_subchannels
    assert scn.h_up.shape == (u, n, m) and scn.h_dn.shape == (n, u, m)
    assert scn.up_order.shape == (m, u) and scn.dn_group_end.shape == (m, u)
    assert scn.h_up.dtype == torch.float32 and scn.assoc.dtype == torch.int64
    assert bool((scn.h_up > 0).all()) and bool((scn.h_dn > 0).all())
    # nearest-AP association: the serving AP has the largest mean
    # path-loss gain (fading averages out over the subchannels)
    mean_gain = scn.h_up.mean(dim=-1)                           # (U, N)
    frac = (mean_gain.argmax(dim=1) == scn.assoc).float().mean()
    assert float(frac) > 0.8
    # orderings agree with the host reference on the drawn gains
    order, gend = network._orderings(scn.own_gain_up().numpy(),
                                     scn.assoc.numpy(), True)
    np.testing.assert_array_equal(scn.up_order.numpy(), order)
    np.testing.assert_array_equal(scn.up_group_end.numpy(), gend)
    # Rayleigh fading: |h|²/path loss ~ Exp(1), unit mean
    evolved = network.evolve_scenario(scn, torch.Generator().manual_seed(1),
                                      rho=1.0)
    torch.testing.assert_close(evolved.h_up, scn.h_up)
    assert network.scenario_drift(scn, evolved) == 0.0


def test_config_fields_round_trip():
    cfg = jnet.small_config(n_users=8, n_subchannels=4)
    assert network.NetworkConfig(**dataclasses.asdict(cfg)) \
        == network.small_config(n_users=8, n_subchannels=4)
