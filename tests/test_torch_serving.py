"""The port's solver-only serving path (``repro_torch.serving``) against the
JAX package's on the CPU: ``build_schedule`` on one outcome, and the
``SplitInferenceCluster`` lifecycle of ``examples/cluster_quickstart.py``
run side by side on the same converted scenarios."""
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
from repro.core import profiles as jprof
from repro.serving import scheduler as jsched
from repro.serving.cluster import SplitInferenceCluster as JCluster
from repro_torch.core import era, ligd, network
from repro_torch.serving import scheduler
from repro_torch.serving.cluster import SplitInferenceCluster
from repro_torch.serving.engine import MultiCellServeEngine

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
    with pytest.raises(NotImplementedError):
        MultiCellServeEngine(object(), None, scns, None)
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


def test_cluster_is_solver_only():
    from repro_torch.core import profiles
    prof = profiles.get_profile("nin", "cpu")
    with pytest.raises(NotImplementedError):
        SplitInferenceCluster(object(), None, prof, device="cpu")
    cl = SplitInferenceCluster(None, None, prof, device="cpu")
    with pytest.raises(NotImplementedError):
        cl.serve_round({})


def test_config_compatible_with_jax_dataclass():
    cfg = jnet.small_config(n_users=U, n_subchannels=M)
    assert dataclasses.asdict(network.small_config(n_users=U,
                                                   n_subchannels=M)) \
        == dataclasses.asdict(cfg)
