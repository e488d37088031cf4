"""Roofline analysis over the dry-run records (the port of the JAX
package's ``launch/roofline.py``).

Three terms per (arch × shape × mesh), all in seconds a step on one H100
SXM (``launch/mesh.py``'s data-sheet constants):
  compute    = FLOPs_per_chip       / 989e12            (bf16 tensor cores)
  memory     = write_bytes_per_chip / 3.35e12           (HBM3 bandwidth)
  collective = coll_bytes_per_chip  / 450e9             (NVLink, each way)

FLOPs and bytes are ``hlo_cost``'s counts of one rank's dispatched
operators (``launch/dryrun.py``).  Bytes are the Σ-outputs HBM-write
proxy; reads ≈ writes within 2× for these graphs, so the memory term is
a lower bound within a small constant.

MODEL_FLOPS (the "useful" floor):
  train:   6 · N_active · tokens   (fwd 2ND + bwd 4ND)
  prefill: 2 · N_active · tokens
  decode:  2 · N_active · batch    (+ KV-read dominated memory term)
divided across chips; the ratio MODEL_FLOPS / counted FLOPs exposes
remat / masked-attention / dispatch waste.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

TOKENS = {
    "train_4k": 256 * 4096,
    "prefill_32k": 32 * 32768,
    "decode_32k": 128,
    "long_500k": 1,
}
MULT = {"train_4k": 6.0, "prefill_32k": 2.0, "decode_32k": 2.0,
        "long_500k": 2.0}


def active_params(cfg) -> tuple[int, int]:
    """(total_params, active_params) from the config's abstract model
    (``steps.abstract_params`` on ``meta``)."""
    from repro_torch.launch.steps import abstract_params
    total = expert = 0
    for name, x in abstract_params(cfg).named_parameters():
        total += x.numel()
        if cfg.n_experts and name.split(".")[-1] in ("w_in", "w_gate",
                                                     "w_out") \
                and x.shape[-3 if x.ndim >= 3 else 0] == cfg.n_experts:
            expert += x.numel()
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return int(total), int(active)


def model_flops_per_chip(cfg, shape, n_chips) -> float:
    _, act = active_params(cfg)
    return MULT[shape] * act * TOKENS[shape] / n_chips


def load_records(mesh="16x16", tag=""):
    recs = []
    for f in sorted(DRYRUN_DIR.glob("*.json")):
        r = json.loads(f.read_text())
        if r.get("mesh") != mesh or r.get("tag", "") != tag:
            continue
        recs.append(r)
    return recs


def roofline_row(rec) -> dict:
    from repro_torch.configs import get_config
    cfg = get_config(rec["arch"])
    pc = rec["per_chip"]
    t_comp = pc["flops"] / PEAK_FLOPS_BF16
    t_mem = pc["write_bytes"] / HBM_BW
    t_coll = pc["collective_bytes_total"] / ICI_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_chip(cfg, rec["shape"], rec["n_chips"])
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "compute_s": t_comp,
        "memory_s": t_mem,
        "collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "useful_ratio": mf / pc["flops"] if pc["flops"] else 0.0,
        "per_chip_gib": rec["mem"]["per_chip_bytes"] / 2 ** 30,
        "fits": rec["mem"]["fits_80gb"],
        "trace_s": rec["trace_s"],
        "collectives": pc["collective_bytes"],
    }


def step_roofline(cost, peaks=None) -> dict:
    """Roofline position of ONE step from an ``hlo_cost.Cost`` measured
    in-process (``hlo_cost.cost_of_callable``), against the platform's
    peaks (``launch.platform.roofline_peaks`` by default).  ``intensity``
    is FLOPs per HBM byte written; the machine balance point is
    peak_flops / mem_bw — below it the step is memory-bound and fusion
    (fewer materialised intermediates) is the lever."""
    if peaks is None:
        from repro_torch.launch.platform import roofline_peaks
        peaks = roofline_peaks()
    flops = float(cost.flops)
    bytes_ = float(cost.write_bytes)
    t_comp = flops / peaks["peak_flops"]
    t_mem = bytes_ / peaks["mem_bw"]
    balance = peaks["peak_flops"] / peaks["mem_bw"]
    return {
        "flops": flops,
        "write_bytes": bytes_,
        "write_bytes_raw": float(cost.write_bytes_raw),
        "intensity": flops / bytes_ if bytes_ else float("inf"),
        "machine_balance": balance,
        "compute_s": t_comp,
        "memory_s": t_mem,
        "bound": "compute" if t_comp >= t_mem else "memory",
        "peaks_basis": peaks.get("basis", "unknown"),
    }


def tiled_step_roofline(cost, *, n_blocks=1, block_vmem_bytes=None,
                        vmem_budget=None, peaks=None) -> dict:
    """``step_roofline`` plus a tiled launch's residency columns: how
    many blocks the launch sweeps, and whether ONE block's working set
    fits the budget.  On the card the budget callers pass is a block's
    shared memory, 227 KB (``SMEM_PER_BLOCK``); the argument names keep
    JAX's (its budget is a TPU core's VMEM)."""
    row = step_roofline(cost, peaks=peaks)
    row["n_blocks"] = int(n_blocks)
    if block_vmem_bytes is not None:
        row["block_vmem_bytes"] = float(block_vmem_bytes)
        if vmem_budget is not None:
            row["block_vmem_fits"] = bool(block_vmem_bytes <= vmem_budget)
    return row


# shared memory one block can use on an H100 (the hopper-kernels guide:
# 227 KB of the SM's 256 KB)
SMEM_PER_BLOCK = 232_448


LEVERS = {
    ("compute", True): "useful ratio < 0.5: cut masked-attention waste "
                       "(flash kernel) / remat recompute",
    ("compute", False): "compute-bound at good useful ratio — already near "
                        "the right wall; next: overlap collectives",
    ("memory", True): "memory-bound: fuse elementwise chains, widen "
                      "microbatch to raise arithmetic intensity",
    ("memory", False): "memory-bound (weights/KV streaming): expected for "
                       "decode; batch more requests per step",
    ("collective", True): "collective-bound: reshard to cut all-gathers "
                          "(seq-parallel off / TP-only serve)",
    ("collective", False): "collective-bound: overlap all-to-all with "
                           "expert compute; larger per-chip shard",
}


def lever(row) -> str:
    key = (row["dominant"], row["useful_ratio"] < 0.5
           if row["dominant"] == "compute" else row["useful_ratio"] < 0.2)
    return LEVERS.get(key, LEVERS[(row["dominant"], True)])


def table(mesh="16x16", tag="") -> str:
    rows = [roofline_row(r) for r in load_records(mesh, tag) if r.get("ok")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    out = ["| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | MODEL/counted | GiB/chip | fits 80 GB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['per_chip_gib']:.2f} | {'Y' if r['fits'] else 'N'} |")
    return "\n".join(out)


def pick_hillclimb_pairs(mesh="16x16"):
    """(worst useful-ratio, most collective-bound, most ERA-representative)."""
    rows = [roofline_row(r) for r in load_records(mesh) if r.get("ok")]
    worst = min((r for r in rows if r["shape"] != "long_500k"),
                key=lambda r: r["useful_ratio"])
    coll = max(rows, key=lambda r: r["collective_s"]
               / max(r["compute_s"] + r["memory_s"], 1e-12))
    # ERA's own regime is multi-user edge *serving*: 32k prefill of the
    # biggest dense model users would split
    rep = next(r for r in rows
               if r["arch"] == "llama3-8b" and r["shape"] == "prefill_32k")
    return worst, coll, rep


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(table(args.mesh, args.tag))
    if args.mesh == "16x16" and not args.tag:
        w, c, r = pick_hillclimb_pairs()
        print("\nhillclimb picks:")
        for label, row in (("worst-ratio", w), ("collective", c),
                           ("representative", r)):
            print(f"  {label}: {row['arch']} × {row['shape']} "
                  f"(dominant={row['dominant']}, "
                  f"ratio={row['useful_ratio']:.2f})")
