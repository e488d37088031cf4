"""The compiled sweep (``SolverSpec.compiled_sweep``, ``core/sweep_graph``)
and the legacy-kwarg shim, on the CPU, against the JAX package.

On the CPU a ``SweepRunner`` runs its steps eagerly on its staged buffers
(the plain version of the graph replay), so these tests prove that every
operand the captured steps read is staged: a runner reused across
scenarios, profiles, thresholds and layers must return a fresh eager
solve's results bitwise.  The capture itself runs only on a card
(``tests/test_torch_kernels.py``'s ``cuda`` cases, ``chip_smoke.py`` phase
22).  Held to JAX: ``SolverSpec``'s validation, ``spec_from_kwargs``, the
shim's warn / fold / vacuous / mutual-exclusion behaviour and the
scheduler constructors' spec, and ``solve(compiled_sweep=False/True)``
against JAX's at ``tests/test_torch_ligd.py``'s bars."""
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_bridge as pb
from port_bridge import one_intra_op_thread  # noqa: F401
from repro.core import era as jera
from repro.core import ligd as jligd
from repro.core import network as jnet
from repro.core import profiles as jprof
from repro.serving import scheduler as jsched
from repro_torch.core import era, ligd, network, profiles, sweep_graph
from repro_torch.distributed import solver_mesh
from repro_torch.serving.scheduler import EraScheduler, MultiCellScheduler

IMPLS = {"autograd": "xla", "fused": "fused"}
BAR = 1e-5                     # the solver's Γ bar (rtol)


def _same(a, b):
    """Two outcomes (or GDResults) equal to the bit."""
    if isinstance(a, ligd.GDResult):
        return (torch.equal(a.gamma, b.gamma) and torch.equal(a.iters, b.iters)
                and all(torch.equal(x, y) for x, y in zip(a.alloc, b.alloc)))
    return (np.array_equal(a.s, b.s)
            and np.array_equal(a.gamma_by_layer, b.gamma_by_layer)
            and np.array_equal(a.iters_by_layer, b.iters_by_layer)
            and torch.equal(a.terms.gamma, b.terms.gamma)
            and all(torch.equal(x, y) for x, y in zip(a.alloc, b.alloc)))


def _cells(n=2, u=6, m=3, seed=0, **cfg_kw):
    cfg = network.small_config(n_users=u, n_subchannels=m, **cfg_kw)
    return [network.make_scenario(torch.Generator().manual_seed(seed + i),
                                  cfg, "cpu") for i in range(n)]


# ------------------------------------------------------ SolverSpec, vs JAX
SPEC_CASES = [
    {}, dict(compiled_sweep=False), dict(compiled_sweep=True),
    dict(backend="chunked", compiled_sweep=False),
    dict(backend="chunked", gd_chunk=4, compiled_sweep=True),
    dict(backend="sharded", compiled_sweep=False),
    dict(backend="multihost", compiled_sweep=False),
    dict(compiled_sweep=False, gd_chunk=4),
    dict(compiled_sweep=False, per_user_split=True, adaptive=True),
]


@pytest.mark.parametrize("kw", SPEC_CASES,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 kw.items()) or "default")
def test_spec_validation_matches_jax(kw):
    """The port's and JAX's SolverSpec accept and refuse the same
    ``compiled_sweep`` combinations, and agree on what they build."""
    def make(mod):
        try:
            return mod.SolverSpec(**kw), None
        except ValueError as e:
            return None, str(e)

    (got, got_err), (want, want_err) = make(ligd), make(jligd)
    assert (got_err is None) == (want_err is None), (got_err, want_err)
    if want_err is not None:
        if "compiled_sweep" in want_err:
            assert "compiled_sweep" in got_err
        return
    for f in ("backend", "gd_chunk", "compiled_sweep", "per_user_split",
              "adaptive"):
        assert getattr(got, f) == getattr(want, f), f
    assert ligd.SolverSpec().compiled_sweep is True


# every combination of the structural trio (left out, at its no-op value,
# or set) and one numeric knob
_ABSENT = object()
KW_GRID = list(itertools.product((_ABSENT, 0, 4), (_ABSENT, None, "mesh"),
                                 (_ABSENT, True, False), (_ABSENT, 0.1)))


def _kw(gd_chunk, mesh, compiled, lr, mesh_obj):
    kw = dict(gd_chunk=gd_chunk, mesh=mesh_obj if mesh == "mesh" else mesh,
              compiled_sweep=compiled, lr=lr)
    return {k: v for k, v in kw.items() if v is not _ABSENT}


def _grid_id(case):
    names = ("gd_chunk", "mesh", "compiled_sweep", "lr")
    return ",".join(f"{n}={v}" for n, v in zip(names, case)
                    if v is not _ABSENT) or "none"


@pytest.fixture(scope="module")
def meshes():
    return (solver_mesh.cells_mesh(1, device="cpu"),
            jax.make_mesh((1,), ("cells",)))


@pytest.mark.parametrize("case", KW_GRID, ids=_grid_id)
def test_spec_from_kwargs_matches_jax(meshes, case):
    """``spec_from_kwargs`` maps the same legacy kwargs onto the same
    backend, chunk and knobs as JAX's, and refuses the same ones."""
    def make(mod, mesh_obj):
        try:
            return mod.spec_from_kwargs(**_kw(*case, mesh_obj)), None
        except ValueError as e:
            return None, str(e)

    got, got_err = make(ligd, meshes[0])
    want, want_err = make(jligd, meshes[1])
    assert (got_err is None) == (want_err is None), (got_err, want_err)
    if want is None:
        return
    for f in ("backend", "gd_chunk", "compiled_sweep", "lr"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.mesh is None) == (want.mesh is None)
    if got.mesh is not None:
        assert got.mesh is meshes[0]


@pytest.mark.parametrize("case", KW_GRID, ids=_grid_id)
@pytest.mark.parametrize("with_spec", (False, True), ids=("kwargs", "spec"))
def test_resolve_spec_shim_matches_jax(meshes, case, with_spec):
    """The shim itself, against JAX's: with and without ``spec=``, the
    same calls warn (DeprecationWarning naming the deprecated kwargs),
    fold silently (vacuous values, numeric knobs), or raise (``spec=``
    mixed with a non-vacuous legacy kwarg, or an invalid spec)."""
    def call(mod, mesh_obj):
        spec = mod.SolverSpec() if with_spec else None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                out = mod._resolve_spec(spec, "where",
                                        **_kw(*case, mesh_obj))
                err = None
            except ValueError as e:
                out, err = None, str(e)
        msgs = sorted(str(c.message) for c in caught
                      if issubclass(c.category, DeprecationWarning))
        return out, err, msgs

    got, got_err, got_w = call(ligd, meshes[0])
    want, want_err, want_w = call(jligd, meshes[1])
    assert got_w == want_w
    assert (got_err is None) == (want_err is None), (got_err, want_err)
    if want_err is not None:
        assert ("not both" in got_err) == ("not both" in want_err)
        return
    for f in ("backend", "gd_chunk", "compiled_sweep", "lr"):
        assert getattr(got, f) == getattr(want, f), f


# ------------------------------------------------- the shim on real solves
def test_solve_legacy_compiled_sweep_warns_and_matches():
    (scn,) = _cells(1)
    prof = profiles.get_profile("nin", "cpu")
    q = torch.full((6,), 0.4)
    with pytest.warns(DeprecationWarning, match="compiled_sweep"):
        legacy = ligd.solve(scn, prof, q, max_steps=5, tol=0.0,
                            compiled_sweep=False)
    spec = ligd.SolverSpec(compiled_sweep=False, max_steps=5, tol=0.0)
    assert _same(legacy, ligd.solve(scn, prof, q, spec=spec))


@pytest.mark.parametrize("legacy", ("gd_chunk", "mesh"))
def test_solve_batch_legacy_kwarg_warns_and_matches(legacy):
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    qs = torch.full((2, 6), 0.4)
    mesh = solver_mesh.cells_mesh(1, device="cpu")
    kw, spec = {
        "gd_chunk": (dict(gd_chunk=4),
                     ligd.SolverSpec(backend="chunked", gd_chunk=4,
                                     max_steps=5, tol=0.0)),
        "mesh": (dict(mesh=mesh),
                 ligd.SolverSpec(backend="sharded", mesh=mesh, max_steps=5,
                                 tol=0.0))}[legacy]
    with pytest.warns(DeprecationWarning, match=legacy):
        got = ligd.solve_batch(scns, prof, qs, max_steps=5, tol=0.0, **kw)
    for a, b in zip(got, ligd.solve_batch(scns, prof, qs, spec=spec)):
        assert _same(a, b)


def test_vacuous_legacy_values_do_not_warn():
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    qs = torch.full((2, 6), 0.4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        ligd.solve(scns[0], prof, qs[0], max_steps=5, tol=0.0,
                   compiled_sweep=True, gd_chunk=0)
        ligd.solve_batch(scns, prof, qs, max_steps=5, tol=0.0, mesh=None,
                         gd_chunk=0, compiled_sweep=True)
        # vacuous values are no conflict with spec=
        ligd.solve(scns[0], prof, qs[0],
                   spec=ligd.SolverSpec(max_steps=5), compiled_sweep=True)


def test_spec_and_legacy_kwargs_are_mutually_exclusive():
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    qs = torch.full((2, 6), 0.4)
    with pytest.raises(ValueError, match="not both"):
        ligd.solve_batch(scns, prof, qs, spec=ligd.SolverSpec(), max_steps=5)
    with pytest.raises(ValueError, match="not both"):
        ligd.solve(scns[0], prof, qs[0], spec=ligd.SolverSpec(), gd_chunk=2)
    with pytest.raises(ValueError, match="not both"):
        ligd.solve(scns[0], prof, qs[0], spec=ligd.SolverSpec(),
                   compiled_sweep=False)


def test_solve_batch_rejects_sequential_loop():
    """compiled_sweep=False is a single-cell path: solve_batch refuses it
    through the spec and through the legacy kwarg (which also warns)."""
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    qs = torch.full((2, 6), 0.4)
    with pytest.raises(ValueError, match="solve_batch"), \
            pytest.warns(DeprecationWarning, match="compiled_sweep"):
        ligd.solve_batch(scns, prof, qs, max_steps=5, compiled_sweep=False)
    with pytest.raises(ValueError, match="solve_batch"):
        ligd.solve_batch(scns, prof, qs,
                         spec=ligd.SolverSpec(compiled_sweep=False,
                                              max_steps=5))


# ------------------------------------------------- scheduler constructors
CTOR_CASES = [
    ("multi", dict(per_user_split=False, max_steps=5, tol=0.0, gd_chunk=4)),
    ("multi", dict(lr=0.1)),
    ("multi", dict(mesh="mesh", gd_chunk=2)),
    ("multi", {}),
    ("era", dict(per_user_split=False, max_steps=5, tol=0.0)),
    ("era", dict(compiled_sweep=False)),
    ("era", {}),
]
_CTOR_DEFAULTS = {
    "multi": dict(per_user_split=True, max_steps=400, lr=0.05, tol=1e-5,
                  gd_chunk=0, mesh=None),
    "era": dict(per_user_split=True, max_steps=400, lr=0.05, tol=1e-5,
                compiled_sweep=True)}


@pytest.mark.parametrize("which,kw", CTOR_CASES,
                         ids=[f"{w}-{','.join(k) or 'none'}"
                              for w, k in CTOR_CASES])
def test_scheduler_ctor_legacy_kwargs_match_jax(meshes, which, kw):
    """The schedulers fold their legacy kwargs onto the spec JAX's
    ``_ctor_spec`` builds (the schedulers' own defaults, ERA+ on)."""
    def resolved(mesh_obj):
        return {k: (mesh_obj if v == "mesh" else v) for k, v in kw.items()}

    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    if which == "multi":
        got = MultiCellScheduler(scns, prof, **resolved(meshes[0])).spec
    else:
        got = EraScheduler(scns[0], prof, **resolved(meshes[0])).spec
    want = jsched._ctor_spec(None, "X", _CTOR_DEFAULTS[which],
                             **resolved(meshes[1]))
    for f in ("backend", "gd_chunk", "compiled_sweep", "per_user_split",
              "max_steps", "lr", "tol"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.mesh is None) == (want.mesh is None)


def test_scheduler_legacy_kwargs_schedule_as_the_spec():
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    ms = MultiCellScheduler(scns, prof, per_user_split=False, max_steps=5,
                            tol=0.0, gd_chunk=4)
    via_spec = MultiCellScheduler(
        scns, prof, spec=ligd.SolverSpec(backend="chunked", gd_chunk=4,
                                         max_steps=5, tol=0.0))
    q = np.full((2, 6), 0.4, np.float32)
    for a, b in zip(ms.schedule(q), via_spec.schedule(q)):
        assert np.array_equal(a.split, b.split)
        assert np.array_equal(a.power_up, b.power_up)
        assert a.gamma == b.gamma
    one = EraScheduler(scns[0], prof, per_user_split=False, max_steps=5,
                       tol=0.0, compiled_sweep=False).schedule(q[0])
    spec = ligd.SolverSpec(per_user_split=False, max_steps=5, tol=0.0,
                           compiled_sweep=False)
    again = EraScheduler(scns[0], prof, spec=spec).schedule(q[0])
    assert np.array_equal(one.split, again.split) and one.gamma == again.gamma


def test_scheduler_ctors_reject_spec_plus_legacy_mix():
    scns = _cells(2)
    prof = profiles.get_profile("nin", "cpu")
    with pytest.raises(ValueError, match="not both"):
        MultiCellScheduler(scns, prof, spec=ligd.SolverSpec(), max_steps=50)
    with pytest.raises(ValueError, match="not both"):
        EraScheduler(scns[0], prof, spec=ligd.SolverSpec(), lr=0.01)
    # an explicit legacy kwarg raises beside spec= even at its default
    with pytest.raises(ValueError, match="not both"):
        MultiCellScheduler(scns, prof, spec=ligd.SolverSpec(), gd_chunk=0)


# ------------------------------------ compiled against eager, port and JAX
def _spec(mod, impl, pus, compiled, adaptive=False):
    return mod.SolverSpec(tol=0.0, max_steps=40, per_user_split=pus,
                          step_impl=impl, compiled_sweep=compiled,
                          adaptive=adaptive)


@pytest.fixture(scope="module")
def single():
    """``test_torch_ligd``'s (12, 6) cell and JAX's outcomes for every
    (compiled_sweep, per_user_split, step kind).  (On other cells the
    port's float32 trajectory can leave JAX's by more than the bar, as
    ROADMAP.md §3's "Chaotic GD trajectories" records.)"""
    cfg = jnet.small_config(n_users=12, n_subchannels=6)
    jscn = jnet.make_scenario(jax.random.PRNGKey(3), cfg)
    jp = jprof.get_profile("nin")
    q = jnp.full((12,), 0.4)
    outs = {(c, pus, impl): jligd.solve(jscn, jp, q, jera.Weights(),
                                        spec=_spec(jligd, IMPLS[impl], pus, c))
            for c in (True, False) for pus in (False, True)
            for impl in IMPLS}
    return outs, pb.scenario(jscn), pb.profile(jp), torch.full((12,), 0.4)


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("pus", (False, True), ids=("global", "per_user"))
def test_compiled_and_eager_sweeps_match_each_other_and_jax(single, impl,
                                                            pus):
    """``solve(compiled_sweep=False)`` (the eager per-layer loop) equals
    the compiled sweep bitwise on the CPU, and each holds to JAX's solve
    with the same ``compiled_sweep`` at ``test_torch_ligd``'s bars."""
    outs, scn, prof, q = single
    other = "fused" if impl == "autograd" else "autograd"
    got = {c: ligd.solve(scn, prof, q, era.Weights(),
                         spec=_spec(ligd, impl, pus, c))
           for c in (True, False)}
    assert _same(got[True], got[False])
    for c in (True, False):
        pb.assert_outcome(got[c], outs[(c, pus, impl)],
                          outs[(c, pus, other)])


@pytest.mark.parametrize("adaptive,impl", [(True, "fused"),
                                           (False, "autograd")])
def test_compiled_sweep_equals_eager_with_stop_tolerance(adaptive, impl):
    """With a real stop tolerance lanes stop at different steps; chunked
    replays (a chunk of 7 in a 30-step budget, so a 2-step tail) and the
    reference backend return the eager loop's outcomes bitwise."""
    scns = _cells(3, u=8, m=4)
    prof = profiles.get_profile("nin", "cpu")
    q = torch.tensor([0.2, 0.4, 0.8])[:, None].expand(3, 8)
    prep = ligd.prepare_batch(scns, prof)
    x_init = era.uniform_alloc(prep.scn_b)
    for chunk in (1, 7):
        runs = [ligd._sweep_core(prep.scn_b, q, x_init, prep.pred_b, 0.05,
                                 1e-4, 30, era.Weights(), prof,
                                 adaptive=adaptive, step_impl=impl,
                                 check_every=chunk, graphed=g)
                for g in (True, False)]
        assert _same(*runs), chunk
        assert len(set(runs[0].iters.sum(dim=1).tolist())) > 1


def test_graphed_sweep_counts_replays_and_reads():
    """The eager loop reads the done flag before every chunk; the runner
    after every replay, and never captures on the CPU."""
    scns = _cells(2, u=8, m=4)
    prof = profiles.get_profile("nin", "cpu")
    q = torch.full((2, 8), 0.4)
    spec = ligd.SolverSpec(backend="chunked", gd_chunk=4, tol=1e-4,
                           max_steps=30)
    ligd.SWEEP_STATS.update(flag_reads=0, replays=0, captures=0,
                            warmup_launches=0)
    out = ligd.solve_batch(scns, prof, q, spec=spec)
    stats = dict(ligd.SWEEP_STATS)
    assert stats["captures"] == stats["warmup_launches"] == 0
    assert stats["replays"] >= sum(-(-o.iters_by_layer.max() // 4)
                                   for o in out[:1])
    assert stats["flag_reads"] <= stats["replays"]


# ------------------------------------------------------- the runner cache
def test_cached_runner_reuse_equals_fresh_eager_solves():
    """One cached runner serves two scenarios (other gains, thresholds,
    network parameters and profile tables, one key) and two layers each,
    in turn and back again; every result equals a fresh eager GD bitwise.
    The two scenarios' results differ by more than the solver's bar, so a
    buffer left stale from the other scenario would fail."""
    w = era.Weights()
    problems = []
    for seed, name, p_max, q0 in ((0, "nin", 0.316, 0.3),
                                  (7, "yolov2", 0.2, 0.5)):
        scn = network.stack_scenarios(_cells(2, u=8, m=4, seed=seed,
                                             p_max_w=p_max))
        prof = profiles.get_profile(name, "cpu")
        q = torch.tensor([q0, 2 * q0])[:, None].expand(2, 8).contiguous()
        problems.append((scn, prof, q))
    assert problems[0][1].n_layers == problems[1][1].n_layers
    kw = dict(lr=0.05, tol=1e-4, max_steps=25, adaptive=False,
              step_impl="fused", check_every=4)
    sweep_graph.clear_cache()
    runners, results = [], {}
    for i in (0, 1, 0):
        scn, prof, q = problems[i]
        x0 = era.uniform_alloc(scn)
        with sweep_graph.staged(scn, prof, q, w, **kw) as runner:
            runners.append(runner)
            for s in (2, 6):
                s_vec = torch.full((2, 8), s, dtype=torch.int64)
                got = runner.run(s_vec, x0)
                want = ligd._gd_core(scn, s_vec, q, x0, kw["lr"], kw["tol"],
                                     kw["max_steps"], w, prof,
                                     check_every=4, graphed=False)
                assert _same(got, want), (i, s)
                results[(i, s)] = want
    assert runners[0] is runners[1] is runners[2]
    assert len(sweep_graph.cached_keys()) == 1
    for s in (2, 6):
        a, b = results[(0, s)].gamma, results[(1, s)].gamma
        assert float(((a - b).abs() / b.abs()).min()) > BAR


def test_runner_cache_key_and_bound(monkeypatch):
    """The key holds the device, the shapes (B, U, M, N, F) and every
    constant a capture bakes in; the cache keeps the ``MAX_RUNNERS`` most
    recently used runners."""
    w = era.Weights()
    scn = network.stack_scenarios(_cells(2, u=8, m=4))
    prof = profiles.get_profile("nin", "cpu")
    q = torch.full((2, 8), 0.4)
    kw = dict(lr=0.05, tol=1e-4, max_steps=25, adaptive=False,
              step_impl="fused", check_every=4)
    key = sweep_graph.runner_key(scn, prof, q, w, **kw)
    assert key == (torch.device("cpu"), 2, 8, 4, scn.cfg.n_aps,
                   prof.n_layers, w, False, "fused", 4, 25, 0.05, 1e-4)
    for change in (dict(lr=0.1), dict(tol=0.0), dict(max_steps=30),
                   dict(check_every=8), dict(adaptive=True),
                   dict(step_impl="autograd")):
        assert sweep_graph.runner_key(scn, prof, q, w,
                                      **{**kw, **change}) != key
    assert sweep_graph.runner_key(scn, prof, q, era.Weights(w_t=0.5),
                                  **kw) != key
    one = network.take_cells(scn, [0])
    assert sweep_graph.runner_key(one, prof, q[:1], w, **kw)[1] == 1
    sweep_graph.clear_cache()
    monkeypatch.setattr(sweep_graph, "MAX_RUNNERS", 2)
    keys = []
    for lr in (0.01, 0.02, 0.03):
        with sweep_graph.staged(scn, prof, q, w, **{**kw, "lr": lr}) as r:
            keys.append(r.key)
    assert sweep_graph.cached_keys() == keys[1:]
    with sweep_graph.staged(scn, prof, q, w, **{**kw, "lr": 0.02}):
        pass
    assert sweep_graph.cached_keys() == [keys[2], keys[1]]
    sweep_graph.clear_cache()
    assert sweep_graph.cached_keys() == []


def test_staged_buffers_refuse_another_shape():
    """A runner's buffers are only ever copied into: a value of another
    shape raises instead of broadcasting into them."""
    w = era.Weights()
    scn = network.stack_scenarios(_cells(2, u=8, m=4))
    prof = profiles.get_profile("nin", "cpu")
    kw = dict(lr=0.05, tol=1e-4, max_steps=5, adaptive=False,
              step_impl="fused", check_every=1)
    with sweep_graph.staged(scn, prof, torch.full((2, 8), 0.4), w,
                            **kw) as runner:
        with pytest.raises(ValueError, match="staged buffer"):
            runner.stage(scn, prof, torch.full((2, 1), 0.4))
        with pytest.raises(ValueError, match="staged buffer"):
            runner.stage(scn, prof, torch.full((2, 8), 0.4,
                                               dtype=torch.float64))


def test_launch_counts_are_per_thread_and_lose_no_update():
    """``era_step_fused.launches`` takes every thread's count (shard threads
    add at once), and each thread's own tally holds only its launches: what
    the runner reads around a capture, so another thread's launches never
    enter a graph's count."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.era_step import kernel as ek
    before = ek.era_step_fused.launches

    def work(n):
        ran0, cap0 = ek.thread_launches()
        for _ in range(n):
            ek.count_launches()
        ran, cap = ek.thread_launches()
        return ran - ran0, cap - cap0

    sizes = [2000 + 100 * i for i in range(8)]
    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(work, sizes))
    assert got == [(n, 0) for n in sizes]
    assert ek.era_step_fused.launches == before + sum(sizes)
    ek.era_step_fused.launches = before


def test_gd_loop_is_shared_and_imports_neither_user():
    """The GD loop's pieces live in ``core/gd_loop``, which both the eager
    loop (``ligd``) and the graphed one (``sweep_graph``) import; neither
    ``gd_loop`` nor ``sweep_graph`` imports ``ligd``."""
    import ast
    import pathlib
    core = pathlib.Path(sweep_graph.__file__).parent
    for name in ("gd_loop", "sweep_graph"):
        tree = ast.parse((core / f"{name}.py").read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {f"{n.module}.{a.name}" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) for a in n.names}
        assert not any("ligd" in x for x in names), (name, names)
    assert ligd.SWEEP_STATS is sweep_graph.gd_loop.SWEEP_STATS
    assert ligd.GDResult is sweep_graph.gd_loop.GDResult
