"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, and the sharded train step against the unsharded one.

  * Specs, leaf for leaf: every architecture's parameters, decode caches
    (batched and long-context) and inputs, on the (16, 16), (2, 16, 16),
    (2, 4) and (1, 1) meshes (JAX's side an ``AbstractMesh``), in
    ``train`` and ``serve`` mode, with ``expert_parallel`` on and off.  A
    port leaf is one layer; JAX's unit-stacked leaf carries a leading
    ``None`` more.
  * ``constrain``: every name on DTensors of a fake 2×4 mesh, held to the
    spec JAX's ``with_sharding_constraint`` receives (or to ``x`` itself
    where JAX lets GSPMD choose).
  * The sharded train step on 8 gloo ranks (2×4) against the port's
    unsharded step for llama3-8b, dbrx-132b and mamba2-780m at the tiny
    float32 configs, d_model 256, d_ff 512, at JAX's own bars
    (``tests/test_distributed_equivalence.py``): the loss within 1e-4,
    every parameter within 2e-4.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from port_bridge import per_layer
from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.models import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
# decode caches: the batched shape and the long-context one (batch 1,
# where the key axis spreads over the data axes)
CACHE_SHAPES = ((128, 32768), (1, 524288))


def _jmesh(sizes, names):
    return jax.sharding.AbstractMesh(sizes, names)


def _norm(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _local_shape(axes, shape, spec):
    """One rank's shape of a ``shape`` tensor laid out by ``spec``."""
    out = []
    for n, ax in zip(shape, spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n //= axes[a] if a is not None else 1
        out.append(n)
    return tuple(out)


def _held(got, want, what):
    assert set(got) == set(want), what
    for name, (spec, stacked) in want.items():
        t = tuple(spec)[1:] if stacked else tuple(spec)
        assert got[name] == _norm(t, len(got[name])), (what, name, got[name],
                                                       t)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.list_architectures())
def test_specs_match_jax(arch, mesh):
    sizes, names = MESHES[mesh]
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jparams, params = jsteps.abstract_params(jcfg), steps.abstract_params(cfg)
    is_spec = lambda x: isinstance(x, P)
    caches = [(jax.eval_shape(lambda b=b, s=s: JT.init_caches(jcfg, b, s)),
               T.init_caches(cfg, b, s, device="meta"))
              for b, s in CACHE_SHAPES]
    inputs = [jsteps.input_specs(jcfg, s) for s in jsteps.SHAPES
              if jsteps.shape_applicable(jcfg, s)]
    for mode in ("train", "serve"):
        for ep in (False, True):
            what = f"{arch} {mesh} {mode} expert_parallel={ep}"
            jr = jsharding.ShardingRules(jcfg, _jmesh(sizes, names),
                                         mode=mode, expert_parallel=ep)
            r = ShardingRules(cfg, AbstractMesh(sizes, names), mode=mode,
                              expert_parallel=ep)
            _held(r.params_tree(params),
                  per_layer(jcfg, jr.params_tree(jparams), is_spec), what)
            for jc, c in caches:
                got = {f"layers.{i}.{k}": s for i, d in
                       enumerate(r.caches_tree(c)) for k, s in d.items()}
                _held(got, per_layer(jcfg, jr.caches_tree(jc), is_spec),
                      what + " caches")
            for spec in inputs:
                for k, v in spec.items():
                    if k not in ("caches", "pos"):
                        assert r.batch_spec(v.shape) == _norm(
                            jr.batch_spec(v.shape), len(v.shape)), (what, k)


# (arch, name, shape, mode, expert_parallel, seq_parallel)
CONSTRAIN_CASES = [
    ("llama3-8b", "heads", (8, 64, 8, 32), "train", False, True),
    ("llama3-8b", "heads", (8, 64, 6, 32), "train", False, True),   # GSPMD
    ("llama3-8b", "heads", (3, 64, 8, 32), "serve", False, True),
    ("llama3-8b", "heads_decode", (8, 1, 8, 32), "serve", False, True),
    ("llama3-8b", "heads_decode", (8, 1, 8, 30), "serve", False, True),
    ("musicgen-medium", "attn_scores", (8, 6, 64, 64), "serve", False, True),
    ("musicgen-medium", "attn_scores", (8, 8, 64, 64), "serve", False,
     True),                                                         # heads
    ("musicgen-medium", "attn_scores", (8, 6, 64, 62), "serve", False, True),
    ("dbrx-132b", "moe_buf", (2, 16, 24, 64), "train", True, True),
    ("dbrx-132b", "moe_buf", (3, 16, 24, 62), "train", True, True),
    ("dbrx-132b", "moe_buf_expert", (2, 16, 24, 64), "train", True, True),
    ("dbrx-132b", "moe_buf_expert", (2, 16, 24, 64), "train", False, True),
    ("mixtral-8x22b", "moe_buf_expert", (2, 6, 24, 64), "train", True,
     True),                                                         # E % 4
    ("dbrx-132b", "moe_groups", (2, 24, 64), "train", True, True),
    ("dbrx-132b", "moe_groups", (1, 24, 62), "train", True, True),
    ("llama3-8b", "resid", (8, 64, 32), "train", False, True),
    ("llama3-8b", "resid", (8, 64, 32), "train", False, False),
    ("llama3-8b", "resid", (8, 62, 32), "train", False, True),
    ("llama3-8b", "resid", (8, 64, 32), "serve", False, True),
    ("llama3-8b", "logits", (8, 64, 512), "train", False, True),
    ("musicgen-medium", "logits", (8, 64, 4, 510), "train", False, True),
    ("llama3-8b", "unnamed", (8, 64, 32), "train", False, True),
]


def test_constrain_names_on_a_fake_mesh(monkeypatch):
    """Each name's layout on a fake 2×4 mesh (8 ranks, ``meta``
    DTensors): the spec JAX hands ``with_sharding_constraint``, captured
    by replacing it, or ``x`` untouched where JAX returns ``x``."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    sizes, names = MESHES["2x4"]
    with dryrun.fake_world(8):
        mesh = make_host_mesh(2, 4)
        for arch, name, shape, mode, ep, sp in CONSTRAIN_CASES:
            jr = jsharding.ShardingRules(
                jconfigs.get_tiny_config(arch), _jmesh(sizes, names),
                mode=mode, expert_parallel=ep, seq_parallel=sp)
            r = ShardingRules(configs.get_tiny_config(arch), mesh, mode=mode,
                              expert_parallel=ep, seq_parallel=sp)
            jx = types.SimpleNamespace(shape=shape, ndim=len(shape))
            want = jr.constrain(jx, name)
            x = distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                  [Replicate(), Replicate()],
                                  src_data_rank=None)
            got = r.constrain(x, name)
            case = (arch, name, shape, mode, ep, sp)
            if want is jx:
                assert got is x, case
                continue
            spec = _norm(want, len(shape))
            assert got.placements == r.placements(spec), (case, spec)
            assert tuple(got.to_local().shape) == _local_shape(
                r.axes, shape, spec), case
        # plain tensors pass through
        y = torch.empty(8, 64, 32)
        assert r.constrain(y, "resid") is y


def test_placements_split_a_dim_pod_major():
    cfg = configs.get_config("llama3-8b")
    r = ShardingRules(cfg, AbstractMesh(*MESHES["2x16x16"]))
    from torch.distributed.tensor import Replicate, Shard
    assert r.placements((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert r.placements((None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        r.placements((("data", "pod"), None))
    assert _local_shape(r.axes, (1024, 64, 32),
                        (("pod", "data"), None, "model")) == (32, 64, 2)


# ------------------------------------------------------------ 8 gloo ranks
EQUIV_ARCHS = ["llama3-8b", "dbrx-132b", "mamba2-780m"]
RANK = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_tiny_config
from repro_torch.data import pipeline
from repro_torch.distributed import multihost
from repro_torch.distributed.sharding import ShardingRules, full_tensor
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.training import optim
multihost.initialize_from_env()
cpu = torch.device("cpu")
mesh = make_host_mesh(2, 4)
# one warmup step: the first Adam update moves each weight by lr (3e-4),
# more than the 2e-4 bar
opt_cfg = optim.AdamWConfig(warmup_steps=1)


def grad_err(grads, want):
    # the worst leaf's largest error against that leaf's max |g|
    return max(float((full_tensor(grads[k]) - w).abs().max()
                     / w.abs().max().clamp_min(1e-30))
               for k, w in want.items())


out = {}
for arch in sys.argv[1:]:
    cfg = get_tiny_config(arch).replace(dtype="float32", d_model=256,
                                        d_ff=512)
    batch = pipeline.for_config(cfg, 32, 8, device=cpu).batch(0, 0)
    new = lambda: steps.init_train_state(
        cfg, torch.Generator().manual_seed(0), cpu)
    ref = new()
    _, _, g_ref = steps.make_grad_fn(cfg)(ref["params"], batch)
    ref, ref_m = steps.make_train_step(cfg, opt_cfg)(ref, batch)
    rules = ShardingRules(cfg, mesh, mode="train")
    state = rules.distribute_state(new())
    place = lambda b: {k: rules.place(x, rules.batch_spec(x.shape))
                       for k, x in b.items()}
    grad_fn = steps.make_grad_fn(cfg, constrain=rules.constrain)
    with implicit_replication():
        _, _, g_sh = grad_fn(state["params"], place(batch))
        # the control: the first half of the batch only
        _, _, g_half = grad_fn(state["params"], place(
            {k: x[:x.shape[0] // 2] for k, x in batch.items()}))
        got, m = steps.make_train_step(cfg, opt_cfg,
                                       constrain=rules.constrain)(
            state, place(batch))
        loss = float(full_tensor(m["loss"]))
        diff = max(float((full_tensor(b).detach() - a.detach()).abs().max())
                   for a, b in zip(ref["params"].parameters(),
                                   got["params"].parameters()))
        g_err, half_err = grad_err(g_sh, g_ref), grad_err(g_half, g_ref)
    out[arch] = {"ref_loss": float(ref_m["loss"]), "loss": loss,
                 "max_param_diff": diff, "grad_err": g_err,
                 "half_batch_grad_err": half_err}
if dist.get_rank() == 0:
    print("EQUIV " + json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded_steps():
    """One 8-rank gloo group (one intra-op thread a rank) running the
    three archs' sharded and unsharded steps; rank 0's report."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(8):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1",
                   REPRO_MH_COORDINATOR=f"localhost:{port}",
                   REPRO_MH_NUM_PROCESSES="8", REPRO_MH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK, *EQUIV_ARCHS], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-2000:]}\n{err[-4000:]}"
    line = next(ln for ln in outs[0][0].splitlines()
                if ln.startswith("EQUIV "))
    return json.loads(line[6:])


@pytest.mark.distributed
@pytest.mark.parametrize("arch", EQUIV_ARCHS)
def test_sharded_train_step_matches_unsharded(arch, sharded_steps):
    """JAX's bars (loss 1e-4, weights 2e-4) after an lr-sized first step,
    and every gradient leaf within 1e-5 of its max |g| (the training
    suite's bar)."""
    r = sharded_steps[arch]
    assert abs(r["loss"] - r["ref_loss"]) < 1e-4, r
    assert r["max_param_diff"] < 2e-4, r
    assert r["grad_err"] <= 1e-5, r


@pytest.mark.distributed
@pytest.mark.parametrize("arch", EQUIV_ARCHS)
def test_sharded_gradient_bar_fails_half_batch(arch, sharded_steps):
    """The control: the sharded gradients of half the batch fail the
    gradient bar the sharded step is held to."""
    r = sharded_steps[arch]
    assert r["half_batch_grad_err"] > 1e-5, r
