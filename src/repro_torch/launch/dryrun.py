"""Multi-pod dry run (the port of the JAX package's ``launch/dryrun.py``):
lay every (architecture × input shape × mesh) pair out on the production
mesh, trace one step of it, check that it fits a card's memory, and count
the roofline inputs (FLOPs, HBM bytes, collective bytes) one rank pays.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--both-meshes] [--force]

Where JAX lowers and compiles against 256 or 512 forced host devices,
the port traces: ``run_pair`` starts a ``fake`` process group of 256 or
512 ranks (rank 0's view; no collective moves data), builds the
production ``DeviceMesh`` over it, places the abstract state
(``steps.abstract_train_state`` / ``abstract_params`` and
``input_specs``, all ``meta``) by ``ShardingRules``, and runs the step
eagerly under ``hlo_cost.CostMode``, which counts rank 0's own operators
and collectives and the peak of its live bytes.  Nothing is allocated
and nothing runs on a card.

The record (``run_pair``) carries JAX's fields, with ``lower_s`` and
``compile_s`` replaced by ``trace_s``:
  * ``mem.per_chip_bytes`` = the rank's parameter and optimiser bytes
    (exact, from the placed shards) + its input/cache bytes + the peak of
    live bytes the step allocates (``mem.basis`` names the method), held
    against ``CHIP_HBM_BYTES`` (``fits_80gb``);
  * ``per_chip`` = ``hlo_cost`` counts of that rank.
JAX's train step scans ``MICROBATCHES[arch]`` microbatches; the dry run
traces the gradient of one microbatch and scales its counts by that
number (``microbatches``/``traced_microbatches`` in the record), traces
the optimiser once, and adds the float32 gradient accumulators to the
memory peak of the one microbatch.

Records go to ``experiments/dryrun_torch/<pair>.json`` (never JAX's
``experiments/dryrun/``, whose records the JAX suite reads).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_architectures
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import (checked_private, make_production_mesh,
                                     mesh_axes)
from repro_torch.launch.steps import (MICROBATCHES, SHAPES, abstract_params,
                                      abstract_train_state, input_specs,
                                      make_decode_step, make_grad_fn,
                                      make_prefill_step, shape_applicable)
from repro_torch.models import attention as attn_mod
from repro_torch.training import optim

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
CHIP_HBM_BYTES = 80e9  # H100 SXM: 80 GB (NVIDIA's data sheet)
MEM_BASIS = ("placed parameter/optimiser/input shards + peak live bytes "
             "of the traced step (hlo_cost.CostMode, dispatch level)")


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``fake`` process group of ``n_ranks`` ranks, this process rank 0,
    for the duration of the block; refuses to replace a real group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up; the dry run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def card_collectives():
    """On a CPU mesh DTensor replaces each all-to-all by an all-gather and
    a chunk (gloo has no all-to-all); the dry run counts what a mesh of
    cards issues, so a Shard-to-Shard move takes DTensor's own all-to-all
    op here (the fake group accepts any collective)."""
    from unittest import mock

    from torch.distributed.tensor import placement_types
    checked_private(placement_types, "shard_dim_alltoall",
                    ("input", "gather_dim", "shard_dim", "mesh", "mesh_dim"))

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    with mock.patch.object(placement_types, "shard_dim_alltoall", alltoall):
        yield


def _local_numel_bytes(tensors):
    """(elements, bytes) one rank holds of ``tensors`` (DTensors or not)."""
    n = b = 0
    for x in tensors:
        local = x.to_local() if hasattr(x, "to_local") else x
        n += local.numel()
        b += local.numel() * local.element_size()
    return n, b


def build_step(arch: str, shape_name: str, mesh, *, expert_parallel=None,
               seq_parallel=True, serve_2d_threshold=8 * 2 ** 30,
               impl="chunked", microbatches=None, score_parallel=None,
               bf16_accum=False):
    """The step of (arch, shape) laid out on ``mesh``: returns (cfg,
    rules, score_parallel, prepare, step).  ``prepare()`` places the
    abstract state and inputs and returns (args, the rank's bytes of
    them); ``step(mode, args)`` runs the step (``mode`` the ``CostMode``
    it runs under) and returns (accumulator bytes, the microbatch
    fields of the record).

    expert_parallel defaults to True for MoE archs (JAX: tensor-parallel
    experts rematerialize the dispatch buffers; expert-parallel dispatch,
    an all-to-all on the model axis, is smaller and the realistic
    layout)."""
    cfg = get_config(arch)
    axes = mesh_axes(mesh)
    if expert_parallel is None:
        expert_parallel = cfg.n_experts > 0
    if cfg.n_experts > 0:
        # shard-local dispatch groups = data-axis extent (GShard
        # per-device capacity); keeps routing scatters local
        data_size = math.prod(n for a, n in axes.items() if a != "model")
        cfg = cfg.replace(moe_dispatch_groups=data_size)
    info = SHAPES[shape_name]
    kind = info["kind"]
    specs = input_specs(cfg, shape_name)
    if score_parallel is None:
        # context-parallel attention scores for prefill of archs whose
        # global-attention head count doesn't divide the model axis
        has_global = any(m == "attn" for m, _ in cfg.pattern)
        score_parallel = (kind == "prefill" and has_global
                          and cfg.n_heads % axes["model"] != 0)

    def place(tree):
        return {k: rules.place(v, rules.batch_spec(v.shape))
                for k, v in tree.items()}

    if kind == "train":
        rules = ShardingRules(cfg, mesh, mode="train",
                              expert_parallel=expert_parallel,
                              seq_parallel=seq_parallel)
        nm = microbatches or MICROBATCHES.get(cfg.name, 1)
        accum = torch.bfloat16 if bf16_accum else torch.float32

        def prepare():
            state = rules.distribute_state(abstract_train_state(cfg))
            # one microbatch: JAX's scan body
            batch = place({k: v[:v.shape[0] // nm]
                           for k, v in specs.items()})
            opt = state["opt"]
            _, nbytes = _local_numel_bytes(
                list(state["params"].parameters()) + [opt.step]
                + list(opt.m.values()) + list(opt.v.values())
                + list(batch.values()))
            return (state, batch), nbytes

        def step(mode, args):
            state, batch = args
            params = dict(state["params"].named_parameters())
            grad_fn = make_grad_fn(cfg, impl=impl, microbatches=1,
                                   constrain=rules.constrain)
            _, _, grads = grad_fn(state["params"], batch)
            one_mb, mode.cost = mode.cost, hlo_cost.Cost()
            optim.apply(optim.AdamWConfig(), params, grads, state["opt"])
            mode.cost.add(one_mb, mult=nm)
            n_local, _ = _local_numel_bytes(params.values())
            accum_bytes = n_local * accum.itemsize if nm > 1 else 0
            return accum_bytes, {"microbatches": nm, "traced_microbatches": 1}
        return cfg, rules, score_parallel, prepare, step

    # serving
    param_bytes = sum(x.numel() * x.element_size()
                      for x in abstract_params(cfg).parameters())
    rules = ShardingRules(cfg, mesh, mode="serve",
                          expert_parallel=expert_parallel)
    # big models get 2-D (fsdp-style) weight sharding even when serving
    if param_bytes // 16 > serve_2d_threshold:
        rules.mode = "train"          # enables the second-dim sharding
        rules.seq_parallel = False

    def prepare():
        params = rules.distribute(abstract_params(cfg), serving=True)
        if kind == "prefill":
            batch = place(specs)
            return (params, batch), _local_numel_bytes(
                list(params.parameters()) + list(batch.values()))[1]
        caches = [{k: rules.place(x, rules.cache_spec((k,), x.shape))
                   for k, x in c.items()} for c in specs["caches"]]
        tokens = place({"tokens": specs["tokens"]})["tokens"]
        return (params, tokens, caches), _local_numel_bytes(
            list(params.parameters()) + [tokens]
            + [x for c in caches for x in c.values()])[1]

    def step(mode, args):
        if kind == "prefill":
            params, batch = args
            make_prefill_step(cfg, impl=impl,
                              constrain=rules.constrain)(params, batch)
        else:
            params, tokens, caches = args
            # the token's position: the cache's last slot
            make_decode_step(cfg, constrain=rules.constrain)(
                params, tokens, info["seq"] - 1, caches)
        return 0, {"microbatches": 1, "traced_microbatches": 1}
    return cfg, rules, score_parallel, prepare, step


def run_pair(arch: str, shape_name: str, *, multi_pod=False,
             expert_parallel=None, seq_parallel=True, impl="chunked",
             microbatches=None, score_parallel=None, bf16_accum=False,
             tag="") -> dict:
    from torch.distributed.tensor.experimental import implicit_replication
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips), card_collectives():
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        cfg, rules, score_par, prepare, step = build_step(
            arch, shape_name, mesh, expert_parallel=expert_parallel,
            seq_parallel=seq_parallel, impl=impl, microbatches=microbatches,
            score_parallel=score_parallel, bf16_accum=bf16_accum)
        grad = SHAPES[shape_name]["kind"] == "train"
        if score_par:
            attn_mod.set_score_constrain(rules.constrain)
        try:
            with implicit_replication(), torch.set_grad_enabled(grad):
                args, arg_bytes = prepare()
                with hlo_cost.CostMode(track_memory=True) as mode:
                    accum_bytes, mb = step(mode, args)
                del args
        finally:
            attn_mod.set_score_constrain(None)
        t_trace = time.time() - t0
    cost = mode.cost
    per_chip = arg_bytes + accum_bytes + mode.peak_bytes
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "tag": tag,
        "ok": True,
        "expert_parallel": rules.expert_parallel,
        "seq_parallel": rules.seq_parallel,
        "score_parallel": bool(score_par),
        "rules_mode": rules.mode,
        "trace_s": round(t_trace, 1),
        **mb,
        "mem": {
            "argument_bytes": arg_bytes,
            "accumulator_bytes": accum_bytes,
            "peak_temp_bytes": mode.peak_bytes,
            "per_chip_bytes": per_chip,
            "fits_80gb": bool(per_chip < CHIP_HBM_BYTES),
            "basis": MEM_BASIS,
        },
        "per_chip": {
            "flops": cost.flops,
            "write_bytes": cost.write_bytes,
            "write_bytes_raw": cost.write_bytes_raw,
            "collective_bytes": cost.coll_bytes,
            "collective_bytes_total": cost.total_coll_bytes,
        },
    }


def pair_key(arch, shape, multi_pod, tag=""):
    mesh = "2x16x16" if multi_pod else "16x16"
    t = f".{tag}" if tag else ""
    return f"{arch}.{shape}.{mesh}{t}"


def all_pairs():
    for arch in list_architectures():
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape_applicable(cfg, shape):
                yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--expert-parallel", action="store_true", default=None)
    ap.add_argument("--no-expert-parallel", dest="expert_parallel",
                    action="store_false")
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--impl", default="chunked",
                    choices=["chunked", "chunked_tri", "naive"])
    ap.add_argument("--score-parallel", action="store_true", default=None)
    ap.add_argument("--bf16-accum", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    pairs = list(all_pairs()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for multi_pod in meshes:
        for arch, shape in pairs:
            key = pair_key(arch, shape, multi_pod, args.tag)
            out = OUT_DIR / f"{key}.json"
            if out.exists() and not args.force:
                print(f"[skip] {key}")
                continue
            print(f"[run ] {key} ...", flush=True)
            try:
                rec = run_pair(arch, shape, multi_pod=multi_pod,
                               expert_parallel=args.expert_parallel,
                               seq_parallel=not args.no_seq_parallel,
                               microbatches=args.microbatches,
                               impl=args.impl,
                               score_parallel=args.score_parallel,
                               bf16_accum=args.bf16_accum, tag=args.tag)
            # one pair's failure is recorded and the sweep goes on
            except Exception as e:  # noqa: BLE001
                failures += 1
                rec = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if multi_pod else "16x16",
                       "tag": args.tag, "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-3000:]}
                print(f"[FAIL] {key}: {e}")
            out.write_text(json.dumps(rec, indent=2))
            if rec.get("ok"):
                m = rec["mem"]
                print(f"[ ok ] {key} trace={rec['trace_s']}s "
                      f"per_chip={m['per_chip_bytes']/2**30:.2f}GiB "
                      f"flops={rec['per_chip']['flops']:.3e} "
                      f"coll={rec['per_chip']['collective_bytes_total']:.3e}",
                      flush=True)
    print(f"done; failures={failures}")
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
