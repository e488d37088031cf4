"""The port's multi-process solver (``SolverSpec(backend='multihost')``,
``repro_torch.distributed.multihost``) on the CPU, mirroring the JAX
package's ``test_multihost_solver.py``.

  * one process: spec validation, the global mesh being the sharded
    default, lane slices and the fence as no-ops, the backend being
    bitwise ``sharded``, the zero-collective audit, and the scheduler
    pinning its mesh once;
  * two gloo processes (``torch.distributed`` through the ``REPRO_MH_*``
    variables; no forced device count: each process shards over
    ``cells_mesh(2, device="cpu")``): 2 processes x 2 shards x 4 lanes
    are bitwise the single-process 4-shard sharded solve of all 8 lanes
    (the shards have the same shape, so the arithmetic is the same), and
    the sweep issues no collective while a fence does; then a fenced
    cluster lifecycle (add_cell, move_user, remove_cell, host-local
    rounds), and a divergent fence tag that raises on every process
    instead of hanging.

The workers import only ``repro_torch``.  Each group gets a port bound
from port 0 (retried once if taken meanwhile: the suite's workers run at
the same time), ``init_process_group`` a 60 s timeout, each worker a
``communicate`` timeout, and every worker is killed if the case fails."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import era, ligd, network, profiles
from repro_torch.distributed import multihost, solver_mesh
from repro_torch.serving.scheduler import MultiCellScheduler
from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 180


def _cpu_mesh(n):
    return solver_mesh.cells_mesh(n, device="cpu")


def _setup(n_cells=3, n_users=6, n_subchannels=3, seed0=0):
    cfg = network.small_config(n_users=n_users, n_subchannels=n_subchannels)
    scns = [network.make_scenario(torch.Generator().manual_seed(seed0 + i),
                                  cfg, "cpu") for i in range(n_cells)]
    prof = profiles.get_profile("nin", "cpu")
    return scns, prof, torch.full((n_cells, n_users), 0.4)


# --------------------------------------------- spec validation / plumbing
def test_multihost_spec_validates():
    spec = ligd.SolverSpec(backend="multihost")
    assert spec.gd_chunk == 0
    assert ligd.SolverSpec(backend="multihost", gd_chunk=8).gd_chunk == 8
    m = _cpu_mesh(2)
    assert ligd.SolverSpec(backend="multihost", mesh=m).mesh is m
    assert ligd.SolverSpec(backend="multihost", mesh=m).run_mesh() is m


def test_multihost_spec_rejections():
    with pytest.raises(ValueError, match="lane_placement"):
        ligd.SolverSpec(backend="multihost", lane_placement="sorted")
    with pytest.raises(ValueError, match="CELL axis"):
        ligd.solve(None, None, None,
                   spec=ligd.SolverSpec(backend="multihost"))
    with pytest.raises(ValueError, match="mesh="):
        ligd.SolverSpec(backend="chunked", mesh=_cpu_mesh(1))


def test_global_mesh_is_cells_mesh_single_process():
    """One process: the multihost mesh IS the sharded one — the identical
    memoised object."""
    assert multihost.global_cells_mesh(2, "cpu") is _cpu_mesh(2)
    if torch.cuda.is_available():
        assert multihost.global_cells_mesh() is solver_mesh.cells_mesh()
        assert (ligd.SolverSpec(backend="multihost").run_mesh()
                is solver_mesh.cells_mesh())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ligd.SolverSpec(backend="multihost").run_mesh()


def test_lane_slice_and_fence_single_process():
    assert multihost.lane_slice(4) == (0, 4)
    multihost.churn_fence("noop")                  # must not block
    info = multihost.initialize_from_env()         # no env vars: no-op
    assert info.n_processes == 1 and info.process_id == 0
    assert multihost.process_count() == 1 and multihost.process_index() == 0


# ------------------------------------------------ single-process numerics
def test_single_process_multihost_is_bitwise_sharded():
    scns, prof, q = _setup()
    mh = ligd.SolverSpec(backend="multihost", mesh=_cpu_mesh(2),
                         max_steps=50, per_user_split=False)
    outs_mh = ligd.solve_batch(scns, prof, q, spec=mh)
    outs_sh = ligd.solve_batch(scns, prof, q,
                               spec=mh.replace(backend="sharded"))
    for a, b in zip(outs_mh, outs_sh):
        assert np.array_equal(a.gamma_by_layer, b.gamma_by_layer)
        assert np.array_equal(a.iters_by_layer, b.iters_by_layer)
        assert np.array_equal(a.s, b.s)
        for la, lb in zip(a.alloc, b.alloc):
            assert torch.equal(la, lb)


def test_sweep_collective_cost_is_zero():
    """The byte audit: the sweep issues no collective at all."""
    scns, prof, q = _setup()
    prep = ligd.prepare_batch(scns, prof, True)
    cost = multihost.sweep_collective_cost(
        _cpu_mesh(2), prep.scn_b, q, era.uniform_alloc(prep.scn_b),
        prep.pred_b, 0.05, 1e-5, 3, era.Weights(), prep.prof_b)
    assert cost.total_coll_bytes == 0.0
    assert cost.coll_bytes == {}


def test_scheduler_pins_multihost_mesh_once():
    scns, prof, q = _setup()
    mesh = _cpu_mesh(2)
    ms = MultiCellScheduler(scns, prof, spec=ligd.SolverSpec(
        backend="multihost", mesh=mesh, max_steps=40, per_user_split=False))
    assert ms.spec.mesh is mesh
    assert not ms.host_local_rounds                # single process
    assert len(ms.schedule(q.numpy())) == len(scns)


# ------------------------------------------------------- subprocess suite
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(code, n_procs=2, extra_env=None):
    """``n_procs`` interpreters running ``code`` in one gloo group (process
    id and count through the REPRO_MH_* variables); their (stdout,
    stderr).  Every worker is killed when the case fails or times out."""
    for attempt in range(2):
        port = _free_port()
        procs = []
        try:
            for pid in range(n_procs):
                env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
                           OMP_NUM_THREADS="1",
                           REPRO_MH_COORDINATOR=f"localhost:{port}",
                           REPRO_MH_NUM_PROCESSES=str(n_procs),
                           REPRO_MH_PROCESS_ID=str(pid), **(extra_env or {}))
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=_ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs = [p.communicate(timeout=WORKER_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt == 0 and any("address already in use" in err.lower()
                                for _, err in outs):
            continue
        for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, (pid, out[-1000:], err[-3000:])
        return outs


_PROLOGUE = """
import os, time
import numpy as np, torch
import torch.distributed as dist
from repro_torch.distributed import multihost, solver_mesh
info = multihost.initialize_from_env()
assert info.n_processes == 2 and dist.get_backend() == "gloo", info
pid = info.process_id
from repro_torch.core import era, ligd, network, profiles
cfg = network.small_config(n_users=6, n_subchannels=3)
prof = profiles.get_profile("nin", "cpu")
def scenario(g):
    return network.make_scenario(torch.Generator().manual_seed(g), cfg,
                                 "cpu")
"""

# 4 local lanes over 2 local CPU shards in each of 2 processes
_EQUIV_WORKER = _PROLOGUE + """
lo, hi = multihost.lane_slice(4)
local = [scenario(g) for g in range(lo, hi)]
q = torch.full((4, 6), 0.4)
mesh = multihost.global_cells_mesh(2, device="cpu")
spec = ligd.SolverSpec(backend="multihost", mesh=mesh, max_steps=60,
                       per_user_split=False)
outs = ligd.solve_batch(local, prof, q, spec=spec)
assert len(outs) == 4                        # local lanes only
np.savez(os.environ["MH_OUT"].format(pid=pid),
         gamma=np.stack([o.gamma_by_layer for o in outs]),
         iters=np.stack([o.iters_by_layer for o in outs]),
         s=np.stack([o.s for o in outs]),
         **{f: np.stack([getattr(o.alloc, f).numpy() for o in outs])
            for f in era.Allocation._fields})
prep = ligd.prepare_batch(local, prof, True)
cost = multihost.sweep_collective_cost(
    mesh, prep.scn_b, q, era.uniform_alloc(prep.scn_b), prep.pred_b,
    spec.lr, spec.tol, 3, era.Weights(), prep.prof_b)
assert cost.total_coll_bytes == 0.0 and cost.coll_bytes == {}, cost
fence = multihost.collective_cost(lambda: multihost.churn_fence("audit"))
assert fence.total_coll_bytes > 0, fence     # the audit sees gloo traffic
dist.destroy_process_group()
print("EQUIV_WORKER_OK", pid)
"""


def test_multihost_matches_sharded_across_processes(tmp_path):
    """2 processes x 2 CPU shards solving 4 lanes each through
    backend='multihost' BITWISE match the single-process 4-shard
    backend='sharded' solve of all 8 lanes: Γ, iterations, splits and
    every allocation leaf, lane for lane."""
    out_tpl = str(tmp_path / "mh_{pid}.npz")
    outs = _run_workers(_EQUIV_WORKER, extra_env={"MH_OUT": out_tpl})
    for pid, (out, _err) in enumerate(outs):
        assert f"EQUIV_WORKER_OK {pid}" in out, out[-1000:]

    scns, prof, q = _setup(n_cells=8)
    ref = ligd.solve_batch(scns, prof, q, spec=ligd.SolverSpec(
        backend="sharded", mesh=_cpu_mesh(4), max_steps=60,
        per_user_split=False))
    want = dict(gamma=np.stack([o.gamma_by_layer for o in ref]),
                iters=np.stack([o.iters_by_layer for o in ref]),
                s=np.stack([o.s for o in ref]),
                **{f: np.stack([getattr(o.alloc, f).numpy() for o in ref])
                   for f in era.Allocation._fields})
    for pid in range(2):
        got = np.load(out_tpl.format(pid=pid))
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(v[4 * pid:4 * pid + 4], got[k]), (pid, k)


_CLUSTER_WORKER = _PROLOGUE + """
from repro_torch.serving.cluster import SplitInferenceCluster
spec = ligd.SolverSpec(backend="multihost", mesh=solver_mesh.cells_mesh(
    2, device="cpu"), max_steps=40, per_user_split=False)
# each process owns a contiguous slice of the fleet: 2 cells a process
lo, hi = multihost.lane_slice(2)
cl = SplitInferenceCluster(None, None, prof, spec=spec, device="cpu")
ids = [cl.add_cell(scenario(g), q0=0.4) for g in range(lo, hi)]
cl.start(threaded=False)
assert cl.scheduler.host_local_rounds
v0 = cl.schedule_version
cl.submit(ids[0], user=1, q_s=0.3)
rnd = cl.step()                              # host-local partial round
assert rnd is not None and rnd.cells == (0,), rnd
assert cl.schedule_version > v0
# coordinated churn: every process meets each fence with the same tag
cid = cl.add_cell(scenario(100 + pid), q0=0.4)
assert cl.n_cells == 3 and cl.lane_of(cid) == 2
mv = cl.move_user(ids[1], cid, user=2)
assert mv.cells == (cl.lane_of(cid),), mv
cl.remove_cell(ids[0])
assert cl.n_cells == 2
cl.submit(cid, user=0, q_s=0.35)             # post-churn rounds stay local
rnd2 = cl.step()
assert rnd2 is not None and rnd2.cells == (cl.lane_of(cid),), rnd2
cl.stop()
assert not cl.errors
# a divergent tag raises on every process, well inside the timeout
t0 = time.perf_counter()
try:
    multihost.churn_fence(f"remove_cell:{pid}")
except RuntimeError as e:
    assert "disagree" in str(e), e
    print("DIVERGED", pid, round(time.perf_counter() - t0, 3))
else:
    raise SystemExit("divergent fence tags did not raise")
dist.destroy_process_group()
print("CLUSTER_WORKER_OK", pid)
"""


def test_multihost_cluster_lifecycle_across_processes():
    """Per-process admission: 2 processes each run a cluster over their
    2-cell slice — bootstrap, host-local partial rounds, and fenced
    add_cell / move_user / remove_cell keeping both processes' churn in
    step; then a divergent churn tag fails both processes."""
    outs = _run_workers(_CLUSTER_WORKER)
    for pid, (out, _err) in enumerate(outs):
        assert f"CLUSTER_WORKER_OK {pid}" in out, out[-1000:]
        took = float(next(ln.split()[2] for ln in out.splitlines()
                          if ln.startswith("DIVERGED")))
        assert took < multihost.PG_TIMEOUT_S
