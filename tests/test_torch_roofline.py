"""The port's roofline module (``repro_torch.launch.roofline``) against the
JAX package's: parameter counts, the model-FLOPs floor, the per-record
row, the in-process step roofline and the lever, on the same inputs with
the same peaks (JAX's module constants set to the card's)."""
import json

import pytest

from repro import configs as jconfigs
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import roofline as jroofline
from repro_torch import configs
from repro_torch.launch import hlo_cost, mesh, platform, roofline

ARCHS = configs.list_architectures()


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_match_jax(arch):
    assert roofline.active_params(configs.get_config(arch)) == \
        jroofline.active_params(jconfigs.get_config(arch))


def _record(arch, shape, mesh_name, n_chips, flops, wbytes, coll,
            per_chip_bytes):
    """A dry-run record both modules read: JAX's ``compile_s`` and
    ``fits_16gib`` beside the port's ``trace_s`` and ``fits_80gb``."""
    return {"arch": arch, "shape": shape, "mesh": mesh_name,
            "n_chips": n_chips, "tag": "", "ok": True,
            "compile_s": 1.5, "trace_s": 1.5,
            "mem": {"per_chip_bytes": per_chip_bytes, "fits_16gib": True,
                    "fits_80gb": True},
            "per_chip": {"flops": flops, "write_bytes": wbytes,
                         "write_bytes_raw": 2 * wbytes,
                         "collective_bytes": {"all-gather": coll},
                         "collective_bytes_total": coll}}


RECORDS = [
    ("llama3-8b", "train_4k", "16x16", 256, 2.6e14, 1.6e12, 2.5e11),
    ("dbrx-132b", "decode_32k", "16x16", 256, 9.1e10, 4.0e10, 1.3e9),
    ("mamba2-780m", "long_500k", "2x16x16", 512, 1.0e8, 2.0e9, 1.7e6),
    ("mixtral-8x22b", "prefill_32k", "16x16", 256, 5.7e14, 1.0e11, 5.7e11),
]


@pytest.mark.parametrize("rec", RECORDS, ids=[r[0] for r in RECORDS])
def test_rows_and_levers_match_jax(rec, monkeypatch):
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jroofline, name, getattr(mesh, name))
    arch, shape, mesh_name, n, flops, wbytes, coll = rec
    r = _record(arch, shape, mesh_name, n, flops, wbytes, coll, 5 * 2**30)
    got, want = roofline.roofline_row(r), jroofline.roofline_row(r)
    for k, v in want.items():
        if k == "compile_s":
            assert got["trace_s"] == v
        else:
            assert got[k] == pytest.approx(v, rel=1e-12), k
    assert roofline.lever(got) == jroofline.lever(want)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert roofline.model_flops_per_chip(cfg, shape, n) == \
        jroofline.model_flops_per_chip(jcfg, shape, n)


def test_step_roofline_matches_jax():
    peaks = {"peak_flops": mesh.PEAK_FLOPS_BF16, "mem_bw": mesh.HBM_BW,
             "basis": "h100-sxm"}
    for flops, wbytes in ((3.3e7, 5.2e5), (1e12, 1e9), (0.0, 0.0)):
        cost = hlo_cost.Cost(flops=flops, write_bytes=wbytes,
                             write_bytes_raw=2 * wbytes)
        jcost = jhlo_cost.Cost(flops=flops, write_bytes=wbytes,
                               write_bytes_raw=2 * wbytes)
        assert roofline.step_roofline(cost, peaks) == \
            jroofline.step_roofline(jcost, peaks)
        got = roofline.tiled_step_roofline(
            cost, n_blocks=4, block_vmem_bytes=300_000,
            vmem_budget=roofline.SMEM_PER_BLOCK, peaks=peaks)
        want = jroofline.tiled_step_roofline(
            jcost, n_blocks=4, block_vmem_bytes=300_000,
            vmem_budget=roofline.SMEM_PER_BLOCK, peaks=peaks)
        assert got == want
        assert got["block_vmem_fits"] is False


def test_default_peaks_are_the_platforms():
    row = roofline.step_roofline(hlo_cost.Cost(flops=1.0, write_bytes=1.0))
    assert row["peaks_basis"] == platform.roofline_peaks()["basis"]


def test_table_and_picks_read_the_ports_records(tmp_path, monkeypatch):
    """``load_records`` reads ``experiments/dryrun_torch`` (here a temporary
    directory in its place), by mesh and tag."""
    assert roofline.DRYRUN_DIR.name == "dryrun_torch"
    monkeypatch.setattr(roofline, "DRYRUN_DIR", tmp_path)
    recs = RECORDS + [("llama3-8b", "prefill_32k", "16x16", 256, 3.0e14,
                       4.0e11, 1.0e11)]
    for arch, shape, mesh_name, n, flops, wbytes, coll in recs:
        r = _record(arch, shape, mesh_name, n, flops, wbytes, coll, 2**30)
        (tmp_path / f"{arch}.{shape}.{mesh_name}.json").write_text(
            json.dumps(r))
    assert len(roofline.load_records("16x16")) == 4
    assert len(roofline.load_records("2x16x16")) == 1
    table = roofline.table("16x16").splitlines()
    assert len(table) == 2 + 4 and "fits 80 GB" in table[0]
    worst, coll, rep = roofline.pick_hillclimb_pairs()
    assert (rep["arch"], rep["shape"]) == ("llama3-8b", "prefill_32k")
    assert worst["useful_ratio"] == min(
        roofline.roofline_row(r)["useful_ratio"]
        for r in roofline.load_records("16x16")
        if r["shape"] != "long_500k")
