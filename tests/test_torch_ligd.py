"""The port's Li-GD solver (``repro_torch.core.ligd``) against the JAX
package's on the CPU, at ``tol=0, max_steps=40`` (every lane runs its full
budget, so iteration counts agree by construction and the comparison sees
the whole Γ trajectory): split decisions and ``iters_by_layer`` exactly
equal, ``gamma_by_layer`` and the final Γ within rtol 1e-5, hard
allocations within 1e-5 of each leaf's scale.  The port's ``autograd`` step
is held against JAX's ``xla``, the port's ``fused`` against JAX's
``fused``.

Normalised-gradient GD amplifies float32 rounding on some trajectories:
on those, JAX's own two step implementations (``xla`` and ``fused``)
already disagree, by up to 7e-4 of scale on one user's ``p`` in these
cases.  There the reference fixes the answer no closer than that, so the
bar becomes twice JAX's own xla-vs-fused spread on that quantity, capped
at ``SPREAD_CAP`` of its scale (``port_bridge.spread_bar``); everywhere
else it stays 1e-5.  Each
widened bar is printed (``pytest -rP``).  The one-hot β leaves of a hard
allocation are held exactly."""
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
from repro_torch.core import era, ligd, network

IMPLS = {"autograd": "xla", "fused": "fused"}
BACKENDS = ("reference", "chunked")
PUS = (False, True)


def _assert_outcome(got, want, other):
    """``got`` (port) against ``want`` (JAX, same step kind); ``other`` is
    JAX's outcome with its other step kind, for the spread."""
    pb.assert_outcome(got, want, other)


def _other(impl):
    return "fused" if impl == "autograd" else "autograd"


def _spec(mod, backend, impl, pus):
    return mod.SolverSpec(backend=backend, tol=0.0, max_steps=40,
                          per_user_split=pus, step_impl=impl)


@pytest.fixture(scope="module")
def single():
    """One (12, 6) cell; JAX outcomes per (per_user_split, step_impl) —
    JAX's two backends agree bitwise, so one reference serves both."""
    cfg = jnet.small_config(n_users=12, n_subchannels=6)
    jscn = jnet.make_scenario(jax.random.PRNGKey(3), cfg)
    jp = jprof.get_profile("nin")
    q = jnp.full((12,), 0.4)
    outs = {(pus, impl): jligd.solve(jscn, jp, q, jera.Weights(),
                                     spec=_spec(jligd, "reference",
                                                IMPLS[impl], pus))
            for pus in PUS for impl in IMPLS}
    return outs, pb.scenario(jscn), pb.profile(jp), torch.full((12,), 0.4)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("pus", PUS, ids=("global", "per_user"))
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_matches_jax(single, backend, pus, impl):
    outs, scn, prof, q = single
    got = ligd.solve(scn, prof, q, era.Weights(),
                     spec=_spec(ligd, backend, impl, pus))
    _assert_outcome(got, outs[(pus, impl)], outs[(pus, _other(impl))])


@pytest.fixture(scope="module")
def batch():
    """Four (8, 4) cells solved as one batch by JAX."""
    cfg = jnet.small_config(n_users=8, n_subchannels=4)
    jscns = [jnet.make_scenario(jax.random.PRNGKey(20 + i), cfg)
             for i in range(4)]
    jp = jprof.get_profile("nin")
    q = jnp.linspace(0.25, 0.5, 32).reshape(4, 8)
    outs = {(pus, impl): jligd.solve_batch(jscns, jp, q, jera.Weights(),
                                           spec=_spec(jligd, "reference",
                                                      IMPLS[impl], pus))
            for pus in PUS for impl in IMPLS}
    return (outs, jscns, jp, q, [pb.scenario(s) for s in jscns],
            pb.profile(jp), torch.as_tensor(np.array(q)))


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("pus", PUS, ids=("global", "per_user"))
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_batch_matches_jax(batch, backend, pus, impl):
    outs, _, _, _, scns, prof, q = batch
    got = ligd.solve_batch(scns, prof, q, era.Weights(),
                           spec=_spec(ligd, backend, impl, pus))
    assert len(got) == 4
    for g, w, o in zip(got, outs[(pus, impl)], outs[(pus, _other(impl))]):
        _assert_outcome(g, w, o)


def test_warm_start_init_alloc_matches_jax(batch):
    """``init_alloc`` seeding (soften_beta of a previous round's hard
    allocations) follows JAX's solve lane for lane."""
    outs, jscns, jp, q, scns, prof, tq = batch
    prev = outs[(True, "fused")]
    jinit = jligd.warm_start_from(prev)
    want, other = (jligd.solve_batch(
        jscns, jp, q, jera.Weights(),
        spec=_spec(jligd, "reference", impl, True), init_alloc=jinit)
        for impl in ("fused", "xla"))
    init = pb.allocation(jinit)
    got = ligd.solve_batch(scns, prof, tq, era.Weights(),
                           spec=_spec(ligd, "chunked", "fused", True),
                           init_alloc=init)
    for g, w, o in zip(got, want, other):
        _assert_outcome(g, w, o)
    # a list of per-cell allocations is stacked the same way
    again = ligd.solve_batch(
        scns, prof, tq, era.Weights(),
        spec=_spec(ligd, "chunked", "fused", True),
        init_alloc=[era.Allocation(*(x[b] for x in init)) for b in range(4)])
    for g, w in zip(again, got):
        np.testing.assert_array_equal(g.iters_by_layer, w.iters_by_layer)
        np.testing.assert_array_equal(g.gamma_by_layer, w.gamma_by_layer)


def test_bucket_padding_lane_equals_exact_solve(batch):
    """A lane padded into a bigger batch (repeat-last, as the scheduler's
    bucket ladder pads) returns its exact-size solve."""
    _, _, _, _, scns, prof, q = batch
    spec = _spec(ligd, "chunked", "fused", True)
    exact = ligd.solve_batch(scns[:3], prof, q[:3], era.Weights(), spec=spec)
    padded = ligd.solve_batch(scns[:3] + [scns[2]], prof,
                              q[[0, 1, 2, 2]], era.Weights(), spec=spec)
    for g, w in zip(padded[:3], exact):
        np.testing.assert_array_equal(g.s, w.s)
        np.testing.assert_array_equal(g.iters_by_layer, w.iters_by_layer)
        np.testing.assert_allclose(g.gamma_by_layer, w.gamma_by_layer,
                                   rtol=1e-6)
    np.testing.assert_array_equal(padded[3].s, padded[2].s)


def test_converged_lanes_freeze_like_isolated_solves():
    """With a real stop tolerance, lanes stop at different steps; each
    lane's iterations and Γ equal its own single-cell solve."""
    cfg = network.small_config(n_users=8, n_subchannels=4)
    scns = [network.make_scenario(torch.Generator().manual_seed(i), cfg,
                                  "cpu") for i in range(3)]
    from repro_torch.core import profiles
    prof = profiles.get_profile("nin", "cpu")
    q = torch.tensor([0.2, 0.4, 0.8])[:, None].expand(3, 8)
    spec = ligd.SolverSpec(backend="chunked", tol=1e-4, max_steps=120)
    together = ligd.solve_batch(scns, prof, q, era.Weights(), spec=spec)
    assert len({int(o.total_iters) for o in together}) > 1
    for b, o in enumerate(together):
        alone = ligd.solve(scns[b], prof, q[b], era.Weights(), spec=spec)
        np.testing.assert_array_equal(o.iters_by_layer, alone.iters_by_layer)
        np.testing.assert_allclose(o.gamma_by_layer, alone.gamma_by_layer,
                                   rtol=1e-6)


def test_solver_spec_validation():
    assert ligd.SolverSpec().step_impl == "fused"
    assert ligd.SolverSpec(backend="chunked").gd_chunk == ligd.DEFAULT_GD_CHUNK
    for backend in ("sharded", "multihost"):
        spec = ligd.SolverSpec(backend=backend)
        assert spec.gd_chunk == 0 and spec.mesh is None
        assert ligd.SolverSpec(backend=backend, gd_chunk=8).gd_chunk == 8
    assert ligd.SolverSpec().run_mesh() is None
    with pytest.raises(ValueError, match="mesh="):
        ligd.SolverSpec(backend="chunked", mesh=("cpu",))
    with pytest.raises(ValueError, match="lane_placement"):
        ligd.SolverSpec(backend="multihost", lane_placement="sorted")
    with pytest.raises(ValueError, match="lane_placement"):
        ligd.SolverSpec(lane_placement="random")
    with pytest.raises(ValueError, match="CELL axis"):
        ligd.solve(None, None, None,
                   spec=ligd.SolverSpec(backend="sharded"))
    with pytest.raises(ValueError):
        ligd.SolverSpec(step_impl="xla")
    with pytest.raises(ValueError):
        ligd.SolverSpec(backend="reference", gd_chunk=4)
    with pytest.raises(ValueError):
        ligd.SolverSpec(tol=-1.0)


def test_warm_start_predecessors_match_jax():
    for name in ("nin", "yolov2", "vgg16"):
        jp = jprof.get_profile(name)
        for warm in (True, False):
            np.testing.assert_array_equal(
                ligd.warm_start_predecessors(pb.profile(jp).uplink_bits, warm),
                jligd.warm_start_predecessors(jp.uplink_bits, warm))
