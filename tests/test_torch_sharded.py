"""The port's cell-sharded solver (``SolverSpec(backend='sharded')``,
``repro_torch.distributed.solver_mesh``) on the CPU, mirroring the JAX
package's ``test_sharded_solver.py``: meshes and lane padding; the port at
1, 3 and 4 CPU shards (``cells_mesh(n, device="cpu")``, the counterpart of
the JAX package's forced host device count) against
``repro.core.ligd.solve_batch``; padding, chunked GD with a warm start,
the wrapper, and the sorted lane placement under skew.

Bars, as the JAX suite holds its sharded path against its unsharded one:
exact splits and iteration counts, Γ within rtol 1e-5.  The port's fused
step is held against JAX's fused step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_bridge as pb
from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)
from repro.core import ligd as jligd
from repro.core import network as jnet
from repro.core import profiles as jprof
from repro_torch.core import era, ligd
from repro_torch.distributed import solver_mesh

SHARDS = (1, 3, 4)


def _mesh(n):
    return solver_mesh.cells_mesh(n, device="cpu")


def _setup(n_cells=4, n_users=8, n_subchannels=4, seed0=0):
    cfg = jnet.small_config(n_users=n_users, n_subchannels=n_subchannels)
    jscns = [jnet.make_scenario(jax.random.PRNGKey(seed0 + i), cfg)
             for i in range(n_cells)]
    jp = jprof.get_profile("nin")
    jq = jnp.full((n_cells, n_users), 0.4)
    return (jscns, jp, jq, [pb.scenario(s) for s in jscns], pb.profile(jp),
            torch.full((n_cells, n_users), 0.4))


def _assert_same_solve(got, want, iters=True):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a.s), np.asarray(b.s))
        if iters:
            np.testing.assert_array_equal(a.iters_by_layer,
                                          b.iters_by_layer)
        np.testing.assert_allclose(a.gamma_by_layer, b.gamma_by_layer,
                                   rtol=1e-5)


# ------------------------------------------------------------------- mesh
def test_cells_mesh_shape():
    for n in (1, 3, 4):
        mesh = _mesh(n)
        assert mesh == (torch.device("cpu"),) * n
    assert _mesh(None) == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver_mesh.cells_mesh()
    else:
        assert len(solver_mesh.cells_mesh()) == torch.cuda.device_count()


def test_pad_lanes():
    assert solver_mesh.pad_lanes(8, 4) is None
    assert solver_mesh.pad_lanes(3, 1) is None
    idx = solver_mesh.pad_lanes(6, 4)
    np.testing.assert_array_equal(idx, [0, 1, 2, 3, 4, 5, 5, 5])


def test_cells_mesh_cache_identity():
    """Repeated resolution returns the IDENTICAL mesh object, and a spec
    resolves an explicit mesh to itself."""
    m = _mesh(3)
    assert _mesh(3) is m and solver_mesh.cells_mesh(3, "cpu") is m
    assert _mesh(1) is _mesh(None)
    spec = ligd.SolverSpec(backend="sharded", mesh=m)
    assert spec.run_mesh() is m and spec.run_mesh() is m
    if torch.cuda.is_available():
        dflt = solver_mesh.cells_mesh()
        assert solver_mesh.cells_mesh() is dflt
        assert solver_mesh.cells_mesh(len(dflt) + 7) is dflt
        assert ligd.SolverSpec(backend="sharded").run_mesh() is dflt


def test_pad_lanes_property_grid():
    """Over a (B, shards) grid including B < shards: padding exists iff B
    is indivisible, pads to the NEXT multiple, keeps the real lanes in
    order, and repeats only the last lane."""
    for b in range(1, 13):
        for shards in range(1, 9):
            idx = solver_mesh.pad_lanes(b, shards)
            if b % shards == 0:
                assert idx is None, (b, shards)
                continue
            assert len(idx) % shards == 0, (b, shards)
            assert b < len(idx) < b + shards, (b, shards)
            np.testing.assert_array_equal(idx[:b], np.arange(b))
            np.testing.assert_array_equal(idx[b:], np.full(len(idx) - b,
                                                           b - 1))


# ------------------------------------------------------------- numerics
@pytest.fixture(scope="module")
def four():
    jscns, jp, jq, scns, prof, q = _setup(n_cells=4)
    want = jligd.solve_batch(jscns, jp, jq, spec=jligd.SolverSpec(
        max_steps=40, step_impl="fused"))
    return want, scns, prof, q


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_solve_matches_jax(four, n_shards):
    """The port's sharded sweep against the JAX package's single-device
    batched solve: same splits and iterations per lane, no leakage across
    shards (3 shards pad the 4 lanes to 6)."""
    want, scns, prof, q = four
    got = ligd.solve_batch(scns, prof, q, spec=ligd.SolverSpec(
        backend="sharded", mesh=_mesh(n_shards), max_steps=40))
    _assert_same_solve(got, want)


def test_sharded_solve_pads_indivisible_batches():
    """B not divisible by the shard count: lanes are padded (repeat-last)
    and the padding is dropped — results still match the unsharded
    path."""
    _, _, _, scns, prof, q = _setup(n_cells=3)
    spec = ligd.SolverSpec(max_steps=20)
    ref = ligd.solve_batch(scns, prof, q, spec=spec)
    for n in (2, 4):
        sh = ligd.solve_batch(scns, prof, q, spec=spec.replace(
            backend="sharded", mesh=_mesh(n)))
        _assert_same_solve(sh, ref)


def test_sharded_solve_chunked_and_warm():
    """mesh × gd_chunk × warm start compose."""
    _, _, _, scns, prof, q = _setup(n_cells=4)
    spec = ligd.SolverSpec(max_steps=5, tol=0.0)
    prev = ligd.solve_batch(scns, prof, q, spec=spec)
    init = ligd.warm_start_from(prev)
    ref = ligd.solve_batch(scns, prof, q, spec=spec, init_alloc=init)
    sh = ligd.solve_batch(scns, prof, q, init_alloc=init, spec=spec.replace(
        backend="sharded", mesh=_mesh(3), gd_chunk=4))
    _assert_same_solve(sh, ref)


def test_solve_batch_sharded_wrapper():
    _, _, _, scns, prof, q = _setup(n_cells=2)
    spec = ligd.SolverSpec(max_steps=5, tol=0.0)
    outs = solver_mesh.solve_batch_sharded(scns, prof, q, mesh=_mesh(2),
                                           spec=spec)
    ref = ligd.solve_batch(scns, prof, q, spec=spec)
    _assert_same_solve(outs, ref)


def test_sharded_solve_really_splits_cells(monkeypatch):
    """On a 4-shard mesh each shard sweeps its own contiguous lanes in its
    own GD loop, and the gathered output keeps lane order."""
    _, _, _, scns, prof, q = _setup(n_cells=4)
    calls = []
    sweep = ligd._sweep_core

    def spy(scn, q_b, *args, **kw):
        calls.append(scn.h_up.clone())
        return sweep(scn, q_b, *args, **kw)

    monkeypatch.setattr(ligd, "_sweep_core", spy)
    prep = ligd.prepare_batch(scns, prof)
    x_init = era.uniform_alloc(prep.scn_b)
    swept = solver_mesh.sharded_sweep(
        _mesh(4), prep.scn_b, q, x_init, prep.pred_b, 0.05, 0.0, 5,
        era.Weights(), prep.prof_b)
    assert [c.shape[0] for c in calls] == [1, 1, 1, 1]
    for b, c in enumerate(calls):
        assert torch.equal(c[0], prep.scn_b.h_up[b])
    assert swept.gamma.shape == (4, prof.n_layers + 1)


def test_shards_on_distinct_devices_run_in_threads(monkeypatch):
    """Shards on distinct devices run in one host thread each (here two
    host devices that compare unequal, ``cpu`` and ``cpu:0``); the result
    is bitwise that of the same two shards run in turn on one device."""
    import threading
    _, _, _, scns, prof, q = _setup(n_cells=4)
    spec = ligd.SolverSpec(backend="sharded", max_steps=5, tol=0.0)
    seq = ligd.solve_batch(scns, prof, q, spec=spec.replace(mesh=_mesh(2)))
    threads = set()
    sweep = ligd._sweep_core

    def spy(*args, **kw):
        threads.add(threading.get_ident())
        return sweep(*args, **kw)

    monkeypatch.setattr(ligd, "_sweep_core", spy)
    two = (torch.device("cpu"), torch.device("cpu", 0))
    par = ligd.solve_batch(scns, prof, q, spec=spec.replace(mesh=two))
    assert len(threads) == 2 and threading.get_ident() not in threads
    for a, b in zip(par, seq):
        np.testing.assert_array_equal(a.gamma_by_layer, b.gamma_by_layer)
        np.testing.assert_array_equal(a.iters_by_layer, b.iters_by_layer)
        for x, y in zip(a.alloc, b.alloc):
            assert torch.equal(x, y)


# ------------------------------------------------------- lane placement
def test_sorted_lane_placement_preserves_outputs_under_skew():
    """``lane_placement='sorted'`` reorders lanes by the previous round's
    iteration counts before the shards run and inverts the permutation on
    output: per-lane results equal the 'none' placement's EXACTLY.  The
    cells converge at different speeds (one is given a stiff config), so
    the sort is non-trivial."""
    _, _, _, scns, prof, q = _setup(n_cells=4)
    scns[0] = pb.scenario(jnet.make_scenario(
        jax.random.PRNGKey(100),
        jnet.small_config(n_users=8, n_subchannels=4, p_max_w=0.02,
                          r_max=8.0)))
    base = ligd.SolverSpec(backend="sharded", mesh=_mesh(4), gd_chunk=4,
                           max_steps=60)
    srt = base.replace(lane_placement="sorted")
    ligd.reset_lane_history()
    try:
        ref = ligd.solve_batch(scns, prof, q, spec=base)
        # round 1 seeds the iteration history; round 2 permutes
        ligd.solve_batch(scns, prof, q, spec=srt)
        perm = ligd._lane_permutation(4, 4)
        assert perm is not None
        assert list(perm) != [0, 1, 2, 3]                # a real reorder
        assert perm[0] == int(np.argmax(ligd._LANE_ITERS[4]))
        out = ligd.solve_batch(scns, prof, q, spec=srt)
        for a, b in zip(ref, out):
            np.testing.assert_array_equal(b.gamma_by_layer,
                                          a.gamma_by_layer)
            np.testing.assert_array_equal(b.s, a.s)
            np.testing.assert_array_equal(b.iters_by_layer,
                                          a.iters_by_layer)
            for x, y in zip(a.alloc, b.alloc):
                assert torch.equal(x, y)
        # the history is each lane's total GD iterations.  The JAX suite
        # asserts that the stiff cell 0 tops it; on these seeds lane 2
        # does, in JAX's fused solve (411, 327, 550, 442) as in the port
        # (JAX's xla solve: 411, 331, 550, 442)
        np.testing.assert_array_equal(ligd._LANE_ITERS[4],
                                      [o.total_iters for o in out])
        np.testing.assert_array_equal(ligd._LANE_ITERS[4],
                                      [411, 327, 550, 442])
    finally:
        ligd.reset_lane_history()


def test_lane_permutation_deals_round_robin():
    ligd.reset_lane_history()
    try:
        assert ligd._lane_permutation(6, 2) is None       # no history
        ligd._LANE_ITERS[6] = np.array([5, 60, 10, 40, 20, 30])
        assert ligd._lane_permutation(6, 1) is None       # one shard
        perm = ligd._lane_permutation(6, 2)
        # hardest first: 1 (60), 3 (40), 5 (30), 4 (20), 2 (10), 0 (5),
        # dealt to shard blocks [0:3) and [3:6) in turn
        np.testing.assert_array_equal(perm, [1, 5, 2, 3, 4, 0])
    finally:
        ligd.reset_lane_history()
