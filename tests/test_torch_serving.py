"""The port's serving path (``repro_torch.serving``) against the JAX
package's on the CPU: ``build_schedule`` on one outcome, the
``SplitInferenceCluster`` lifecycle of ``examples/cluster_quickstart.py``
run side by side on the same converted scenarios, and served rounds of a
tiny model whose weights cross over through ``interop.model_from_numpy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_bridge as pb
from repro.core import era as jera
from repro.core import ligd as jligd
from repro.core import network as jnet
from repro.configs import get_tiny_config as jtiny
from repro.core import profiles as jprof
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro.serving.cluster import SplitInferenceCluster as JCluster
from repro_torch import interop
from repro_torch.configs import get_tiny_config
from repro_torch.core import era, ligd, network, profiles
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.models import transformer as T
from repro_torch.serving import scheduler
from repro_torch.serving.cluster import SplitInferenceCluster
from repro_torch.serving.engine import MultiCellServeEngine, SplitServeEngine

U, M = 12, 6
SPEC = dict(tol=0.0, max_steps=40, per_user_split=True)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _jscn(seed):
    cfg = jnet.small_config(n_users=U, n_subchannels=M)
    return jnet.make_scenario(jax.random.PRNGKey(seed), cfg)


def _assert_schedule(got, want):
    """Equal splits and subchannels, Γ within rtol 1e-5.  The per-user
    rows (powers, compute units, predicted delays, rates) follow the
    continuous allocation, which float32 GD moves by up to ~1e-4 of a
    leaf's scale between the JAX package's own two step implementations
    (tests/test_torch_ligd.py), so they are held at 1e-4 of their
    scale."""
    np.testing.assert_array_equal(got.split, want.split)
    np.testing.assert_array_equal(got.subchannel_up, want.subchannel_up)
    np.testing.assert_array_equal(got.subchannel_dn, want.subchannel_dn)
    np.testing.assert_allclose(got.gamma, want.gamma, rtol=1e-5)
    for f in ("power_up", "power_dn", "compute_units", "pred_latency",
              "pred_energy", "uplink_rate", "downlink_rate"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f) / np.max(np.abs(w)),
                                   w / np.max(np.abs(w)), atol=1e-4,
                                   err_msg=f)
    assert got.iters == want.iters


def test_build_schedule_matches_jax():
    jscn = _jscn(4)
    jp = jprof.get_profile("yolov2")
    out = jligd.solve(jscn, jp, jnp.full((U,), 0.3), jera.Weights(),
                      spec=jligd.SolverSpec(max_steps=30))
    want = jsched.build_schedule(jscn, out)
    port_out = ligd.LiGDOutcome(
        s=np.asarray(out.s), alloc=pb.allocation(out.alloc),
        terms=era.Terms(*(torch.as_tensor(np.array(x)) for x in out.terms)),
        gamma_by_layer=out.gamma_by_layer, iters_by_layer=out.iters_by_layer,
        total_iters=out.total_iters)
    got = scheduler.build_schedule(pb.scenario(jscn), port_out)
    _assert_schedule(got, want)
    assert set(got.groups()) == set(want.groups())


def test_bucket_ladder_matches_jax():
    for n in (1, 2, 3, 5, 8):
        assert scheduler.bucket_sizes(n) == jsched.bucket_sizes(n)
        for k in range(1, n + 1):
            for policy in ("pow2", "exact", "full"):
                assert scheduler.bucket_for(k, n, policy) \
                    == jsched.bucket_for(k, n, policy)


@pytest.fixture(scope="module")
def lifecycle():
    """The quickstart lifecycle on both clusters, recording every
    installed schedule and version along the way."""
    jp = jprof.get_profile("yolov2")
    jscns = {s: _jscn(s) for s in (0, 1, 2, 3)}
    drifted = jnet.evolve_scenario(jscns[2], jax.random.PRNGKey(9), rho=0.5)

    def drive(cl, scn, drift_scn):
        rec = {}
        a, b, c = (cl.add_cell(scn(s)) for s in (0, 1, 2))
        rec["v_boot"] = cl.start(threaded=False)
        rec["boot"] = [cl.installed_schedule(x) for x in (a, b, c)]
        cl.submit(b, user=3, q_s=0.25)
        rec["drift"] = cl.observe(c, drift_scn)
        rnd = cl.step()
        rec["round"] = (rnd.cells, rnd.version, rnd.total_iters)
        rec["after_round"] = [cl.installed_schedule(x) for x in (a, b, c)]
        sched_b = cl.installed_schedule(b)
        d = cl.add_cell(scn(3), q0=0.3)
        rec["join"] = (cl.schedule_version, cl.installed_schedule(d))
        cl.remove_cell(a)
        rec["b_carried"] = cl.installed_schedule(b) is sched_b
        rec["leave"] = (cl.schedule_version, cl.cell_ids())
        mv = cl.move_user(b, d, 2)
        rec["move"] = (mv.cells, mv.version, cl.installed_schedule(d))
        rec["posted_d"] = np.asarray(cl.posted_q(d))
        rec["b_after_move"] = cl.installed_schedule(b) is sched_b
        cl.stop()
        return rec

    jcl = JCluster(None, None, jp, default_q_s=0.4, clock=FakeClock(),
                   spec=jligd.SolverSpec(step_impl="fused", **SPEC))
    want = drive(jcl, lambda s: jscns[s], drifted)
    tcl = SplitInferenceCluster(None, None, pb.profile(jp), default_q_s=0.4,
                                clock=FakeClock(),
                                spec=ligd.SolverSpec(**SPEC), device="cpu")
    got = drive(tcl, lambda s: pb.scenario(jscns[s]), pb.scenario(drifted))
    return got, want


def test_cluster_bootstrap_matches_jax(lifecycle):
    got, want = lifecycle
    assert got["v_boot"] == want["v_boot"] == 1
    for g, w in zip(got["boot"], want["boot"]):
        _assert_schedule(g, w)


def test_cluster_round_matches_jax(lifecycle):
    got, want = lifecycle
    np.testing.assert_allclose(got["drift"], want["drift"], rtol=1e-5)
    assert got["round"] == want["round"]
    for g, w in zip(got["after_round"], want["after_round"]):
        _assert_schedule(g, w)


def test_cluster_churn_matches_jax(lifecycle):
    got, want = lifecycle
    assert got["join"][0] == want["join"][0]
    _assert_schedule(got["join"][1], want["join"][1])
    assert got["leave"] == want["leave"]
    assert got["b_carried"] and want["b_carried"]
    assert got["move"][:2] == want["move"][:2]
    _assert_schedule(got["move"][2], want["move"][2])
    np.testing.assert_array_equal(got["posted_d"], want["posted_d"])
    assert got["b_after_move"] and want["b_after_move"]


def test_engine_schedule_store():
    cfg = network.small_config(n_users=4, n_subchannels=2)
    scns = [network.make_scenario(torch.Generator().manual_seed(i), cfg,
                                  "cpu") for i in range(2)]
    eng = MultiCellServeEngine(None, None, scns, None)
    s0, s1, s2 = (object() for _ in range(3))
    assert eng.schedule_version == 0
    assert eng.install_schedules([s0, s1]) == 1
    assert eng.swap_schedules({1: s2}) == 2
    assert eng.current_schedules().schedules == (s0, s2)
    assert eng.resize(scns[:1], keep={0: 1}) == 3
    assert eng.current_schedules().schedules == (s2,)
    with pytest.raises(ValueError):
        eng.swap_schedules({4: s0})


def _tiny_model(name, seed=0):
    """A tiny float32 model on both sides, carrying the same weights."""
    jcfg = jtiny(name).replace(dtype="float32")
    cfg = get_tiny_config(name).replace(dtype="float32")
    jparams = JT.init(jax.random.PRNGKey(seed), jcfg)
    model = interop.model_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, cfg, jparams, model


def _assert_result(r, steps):
    np.testing.assert_allclose(
        r.latency_s, r.t_device + r.t_uplink + r.t_edge + r.t_downlink,
        rtol=1e-6)
    assert r.latency_s > 0
    assert r.tokens_out.shape == (steps,)


def test_cluster_with_model_serves_round_on_cpu():
    """A cluster built with a model serves every user of every cell on the
    installed schedules, through both kernels' CPU dispatch, and rejects
    a model on another device than its own."""
    _, cfg, _, model = _tiny_model("recurrentgemma-2b")
    prof = profiles.transformer_profile(cfg, seq=16, device="cpu")
    ncfg = network.small_config(n_users=6, n_subchannels=3)
    cl = SplitInferenceCluster(model, cfg, prof, clock=FakeClock(),
                               spec=ligd.SolverSpec(**SPEC), device="cpu")
    ids = [cl.add_cell(network.make_scenario(
        torch.Generator().manual_seed(i), ncfg, "cpu")) for i in range(2)]
    cl.start(threaded=False)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 6, 16)).astype(np.int32)
    flash0, scan0 = flash_attention_bshd.launches, rglru_scan.launches
    out = cl.serve_round({c: toks[i] for i, c in enumerate(ids)},
                         decode_steps=3)
    # CPU tensors take the plain versions: nothing is launched
    assert (flash_attention_bshd.launches, rglru_scan.launches) \
        == (flash0, scan0)
    assert sorted(out) == sorted(ids)
    for cid in ids:
        assert [r.user for r in out[cid]] == list(range(6))
        for r in out[cid]:
            _assert_result(r, 3)
            assert 0 <= r.tokens_out.min() and \
                r.tokens_out.max() < cfg.vocab_size
    by_lane = cl.serve_round(toks, decode_steps=3)
    for cid in ids:
        for r, q in zip(by_lane[cid], out[cid]):
            np.testing.assert_array_equal(r.tokens_out, q.tokens_out)
    with pytest.raises(ValueError, match="missing tokens"):
        cl.serve_round({ids[0]: toks[0]})
    cl.stop()
    with pytest.raises(ValueError, match="lies on"):
        SplitInferenceCluster(model, cfg, prof, device="meta")
    solver_only = SplitInferenceCluster(None, None, prof, device="cpu")
    solver_only.add_cell(network.make_scenario(
        torch.Generator().manual_seed(0), ncfg, "cpu"))
    solver_only.start(threaded=False)
    with pytest.raises(RuntimeError, match="solver-only"):
        solver_only.serve_round(toks[:1])


def test_split_serve_engine_matches_jax():
    """The one-cell engine: solve then execute, equal to JAX's."""
    jcfg, cfg, jparams, model = _tiny_model("llama3-8b")
    jscn = _jscn(30)
    spec = dict(SPEC, per_user_split=False)
    jp = jprof.transformer_profile(jcfg, seq=12)
    prof = profiles.transformer_profile(cfg, seq=12, device="cpu")
    jeng = jengine.SplitServeEngine(
        jparams, jcfg, jscn, jp, jsched.EraScheduler(
            jscn, jp, spec=jligd.SolverSpec(step_impl="fused", **spec)))
    scn = pb.scenario(jscn)
    eng = SplitServeEngine(model, cfg, scn, prof, scheduler.EraScheduler(
        scn, prof, spec=ligd.SolverSpec(**spec)))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (U, 12)).astype(np.int32)
    q = np.full(U, 0.05, np.float32)
    want = jeng.serve_round(toks, q, decode_steps=2)
    got = eng.serve_round(toks, q, decode_steps=2)
    assert [r.user for r in got] == [r.user for r in want] == list(range(U))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens_out, w.tokens_out)
        np.testing.assert_allclose(g.latency_s, w.latency_s, rtol=1e-5)
        _assert_result(g, 2)


@pytest.mark.parametrize("name", ["gemma-2b", "recurrentgemma-2b",
                                  "mamba2-780m"])
def test_multicell_serve_round_matches_jax(name):
    """One lockstep ``serve_round`` (solve, install, execute, decode 3
    steps) on both engines: equal splits and tokens, latencies at rtol
    1e-5."""
    jcfg, cfg, jparams, model = _tiny_model(name)
    s = 16
    jp = jprof.transformer_profile(jcfg, seq=s)
    prof = profiles.transformer_profile(cfg, seq=s, device="cpu")
    jscns = [_jscn(20 + i) for i in range(2)]
    jsch = jsched.MultiCellScheduler(
        jscns, jp, spec=jligd.SolverSpec(step_impl="fused", **SPEC))
    sch = scheduler.MultiCellScheduler(
        [pb.scenario(x) for x in jscns], prof, spec=ligd.SolverSpec(**SPEC))
    jeng = jengine.MultiCellServeEngine(jparams, jcfg, jscns, jsch)
    eng = MultiCellServeEngine(model, cfg, sch.scns, sch)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, U, s)).astype(np.int32)
    q = np.full((2, U), 0.05, np.float32)
    want = jeng.serve_round(toks, q, decode_steps=3)
    got = eng.serve_round(toks, q, decode_steps=3)
    for b in range(2):
        np.testing.assert_array_equal(
            eng.current_schedules().schedules[b].split,
            jeng.current_schedules().schedules[b].split)
        for g, w in zip(got[b], want[b]):
            assert g.user == w.user
            np.testing.assert_array_equal(g.tokens_out, w.tokens_out)
            for f in ("latency_s", "t_device", "t_uplink", "t_edge",
                      "t_downlink"):
                np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                           rtol=1e-5, err_msg=f)
            _assert_result(g, 3)
    # the solver sends every user of these cells edge-only (split 0); a
    # schedule that spreads them over every split point exercises the
    # device prefix, the crossing tensor and the uplink term
    f = cfg.n_layers
    mixed = [dataclasses.replace(x, split=np.arange(U) % (f + 1))
             for x in jeng.current_schedules().schedules]
    jeng.install_schedules(mixed)
    eng.install_schedules([scheduler.Schedule(**vars(x)) for x in mixed])
    for steps in (0, 2):
        want = jeng.serve_scheduled_round(toks, decode_steps=steps)
        got = eng.serve_scheduled_round(toks, decode_steps=steps)
        for b in range(2):
            for g, w in zip(got[b], want[b]):
                np.testing.assert_array_equal(g.tokens_out, w.tokens_out)
                np.testing.assert_allclose(g.latency_s, w.latency_s,
                                           rtol=1e-5)
                np.testing.assert_allclose(g.t_uplink, w.t_uplink,
                                           rtol=1e-5)
    assert {len(g) for g in mixed[0].groups().values()} != {U}


def test_config_compatible_with_jax_dataclass():
    cfg = jnet.small_config(n_users=U, n_subchannels=M)
    assert dataclasses.asdict(network.small_config(n_users=U,
                                                   n_subchannels=M)) \
        == dataclasses.asdict(cfg)
