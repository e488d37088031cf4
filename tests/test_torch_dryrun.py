"""The port's dry run (``repro_torch.launch.dryrun``) and the abstract half
of ``launch.steps`` against the JAX package: input stand-ins, the bytes a
rank holds of the placed train state, and ``run_pair``'s records, on the
fake 256- and 512-rank production meshes (``meta`` tensors; nothing is
allocated)."""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from port_bridge import per_layer
from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro_torch import configs
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = list(dryrun.all_pairs())


def test_the_pairs_are_jaxs():
    """JAX's ``dryrun.all_pairs`` (not imported: it forces the host
    device count at import), from the same tables."""
    want = [(a, s) for a in jconfigs.list_architectures()
            for s in jsteps.SHAPES
            if jsteps.shape_applicable(jconfigs.get_config(a), s)]
    assert PAIRS == want
    assert len(PAIRS) == 34


def _dtype(x):
    return str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_input_specs_match_jax(arch, shape):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    want, got = jsteps.input_specs(jcfg, shape), steps.input_specs(cfg, shape)
    assert set(got) == set(want)
    for k, w in want.items():
        if k == "caches":
            caches = {f"layers.{i}.{n}": x for i, c in enumerate(got[k])
                      for n, x in c.items()}
            jc = per_layer(jcfg, w)
            assert set(caches) == set(jc)
            for name, (leaf, stacked) in jc.items():
                shape_ = leaf.shape[1:] if stacked else leaf.shape
                assert tuple(caches[name].shape) == tuple(shape_), name
                assert _dtype(caches[name]) == _dtype(leaf), name
                assert caches[name].device.type == "meta"
            continue
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k]) == _dtype(w), k
        assert got[k].device.type == "meta"


def _spec_bytes(shape, spec, itemsize, axes):
    n = int(np.prod(shape))
    for ax in tuple(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                n //= axes[a]
    return n * itemsize


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch", configs.list_architectures())
def test_state_bytes_per_chip_are_what_jaxs_specs_imply(arch, multi_pod):
    """Parameters (their dtype), m and v (float32, the parameters'
    layout) and the int32 step: one rank's bytes of the placed state
    equal those JAX's train-mode specs imply."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    ep = cfg.n_experts > 0
    sizes, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    axes = dict(zip(names, sizes))
    jr = jsharding.ShardingRules(
        jcfg, jax.sharding.AbstractMesh(sizes, names), mode="train",
        expert_parallel=ep)
    shapes = jsteps.abstract_params(jcfg)
    specs = jr.params_tree(shapes)
    leaves = zip(jax.tree_util.tree_leaves(shapes),
                 jax.tree_util.tree_leaves(
                     specs, is_leaf=lambda x: isinstance(x, P)))
    want = 4                                            # the step
    for leaf, spec in leaves:
        want += _spec_bytes(leaf.shape, spec, leaf.dtype.itemsize, axes)
        want += 2 * _spec_bytes(leaf.shape, spec, 4, axes)
    with dryrun.fake_world(int(np.prod(sizes))):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = ShardingRules(cfg, mesh, mode="train", expert_parallel=ep)
        state = rules.distribute_state(steps.abstract_train_state(cfg))
        opt = state["opt"]
        _, got = dryrun._local_numel_bytes(
            list(state["params"].parameters()) + [opt.step]
            + list(opt.m.values()) + list(opt.v.values()))
    assert got == want


def _check_record(rec, arch, shape, mesh, n_chips):
    assert rec["ok"] and rec["arch"] == arch and rec["shape"] == shape
    assert rec["mesh"] == mesh and rec["n_chips"] == n_chips
    m = rec["mem"]
    assert m["per_chip_bytes"] == (m["argument_bytes"]
                                   + m["accumulator_bytes"]
                                   + m["peak_temp_bytes"])
    assert m["fits_80gb"] == (m["per_chip_bytes"] < 80e9)
    pc = rec["per_chip"]
    assert pc["flops"] > 0 and pc["write_bytes"] > 0
    assert pc["write_bytes_raw"] >= pc["write_bytes"]
    assert pc["collective_bytes_total"] == pytest.approx(
        sum(pc["collective_bytes"].values()))
    assert "trace_s" in rec and "compile_s" not in rec
    json.dumps(rec)


def test_run_pair_full_size():
    """mamba2-780m's long_500k decode on the 2×16×16 mesh (512 ranks)."""
    rec = dryrun.run_pair("mamba2-780m", "long_500k", multi_pod=True)
    _check_record(rec, "mamba2-780m", "long_500k", "2x16x16", 512)
    assert rec["mem"]["fits_80gb"]
    assert rec["microbatches"] == rec["traced_microbatches"] == 1


# tiny widths and depths at the production shapes and meshes: each kind
# of step, MoE dispatch on the mesh, vision and audio inputs
TINY_PAIRS = [("llama3-8b", "train_4k"), ("dbrx-132b", "train_4k"),
              ("mixtral-8x22b", "prefill_32k"), ("qwen2-vl-72b", "train_4k"),
              ("musicgen-medium", "decode_32k"),
              ("recurrentgemma-2b", "long_500k")]


@pytest.mark.parametrize("arch,shape", TINY_PAIRS)
def test_run_pair_tiny(arch, shape, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", configs.get_tiny_config)
    rec = dryrun.run_pair(arch, shape)
    _check_record(rec, arch, shape, "16x16", 256)
    if configs.get_config(arch).n_experts:
        assert rec["expert_parallel"]
    if shape == "train_4k":
        assert rec["per_chip"]["collective_bytes"].get("reduce-scatter", 0) \
            > 0                          # ZeRO-3 gradients to their shards


def test_main_writes_only_the_ports_records(tmp_path, monkeypatch, capsys):
    jax_dir = ROOT / "experiments" / "dryrun"
    before = sorted(jax_dir.glob("*")) if jax_dir.exists() else None
    assert dryrun.OUT_DIR.name == "dryrun_torch"
    out = tmp_path / "dryrun_torch"
    monkeypatch.setattr(dryrun, "OUT_DIR", out)
    argv = ["--arch", "mamba2-780m", "--shape", "long_500k", "--multi-pod"]
    assert dryrun.main(argv) == 0
    rec = json.loads((out / "mamba2-780m.long_500k.2x16x16.json")
                     .read_text())
    _check_record(rec, "mamba2-780m", "long_500k", "2x16x16", 512)
    assert dryrun.main(argv) == 0                     # cached: skipped
    assert "[skip] mamba2-780m.long_500k.2x16x16" in capsys.readouterr().out
    after = sorted(jax_dir.glob("*")) if jax_dir.exists() else None
    assert after == before


def test_importing_starts_no_process_group():
    assert not torch.distributed.is_initialized()
    with dryrun.fake_world(4):
        assert torch.distributed.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world(4):
                pass
    assert not torch.distributed.is_initialized()
