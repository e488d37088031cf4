"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``, whose ``path`` names the runner in
``paths/``) and a traffic mix (``traffic/<name>.json``).  A run sets up
(the runner draws its inputs and weights from the seed and warms up the
cell's shapes), measures for ``--seconds``, then checks what the timed
path produced against the plain reference under ``reference/``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (each read by ``metrics/<name>.py``)
from a device trace of a bounded stretch of the window.

The last line of standard output is one JSON object; the numbers compared
with their limits end standard error and the result line.  Without a
CUDA card (or with fewer than the cell asks for), and if the JAX stack or
the JAX package is loaded, the run prints no result and exits non-zero.
"""
from __future__ import annotations

import os
import sys
import time

_T_IMPORT = time.monotonic()


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was first imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# the program's build and kernel caches stay inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "portbench",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "portbench",
                                              "triton")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench.lib import common  # noqa: E402
from portbench.lib.trace import Stretch  # noqa: E402


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             overrides=None, t_started: float = None, after=None) -> dict:
    """One run of ``cell``; returns the result object (without printing).
    ``overrides`` replaces entries of the configuration and the mix (the
    CPU tests' small sizes); ``after(path, st, rec)``, called once the
    check has run, adds what it returns under the key "after" (the
    controls' readings)."""
    t_started = time.monotonic() - _process_age_s() if t_started is None \
        else t_started
    man = common.manifest()
    w = common.workload(man, cell)
    cfg, mix = common.config(w["config"]), common.traffic(w["traffic"])
    for part, repl in (overrides or {}).items():
        {"config": cfg, "traffic": mix}[part].update(repl)
    path = common.load_module("paths", cfg["path"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    st = path.setup(cfg, mix, seed, seconds, device)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.monotonic() - t_started
    stretch = Stretch() if (trace and cuda) else None
    rec = path.window(st, seconds, stretch)
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    metrics = {}
    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    tr = stretch.reduce() if stretch is not None else None
    if not trace:
        vals = dict(path.e2e(st, rec), peak_gib=peak / 2**30, setup_s=setup_s)
        for m in common.metrics_for(man, "end_to_end", cell):
            if m["name"] in vals:
                metrics[m["name"]] = vals[m["name"]]
    else:
        ctx = dict(cell=cell, st=st, rec=rec, trace=tr, path=path)
        for m in common.metrics_for(man, "per_layer", cell):
            v = common.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = v
    attempted, failed = path.counts(st, rec)
    path.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = path.check(st, rec, seed)
    correct = all(v <= lim for _, v, lim in checks)
    out = dict(
        correct=bool(correct), attempted=int(attempted), failed=int(failed),
        metrics={k: {"value": float(v), "unit": units[k]}
                 for k, v in metrics.items()},
        device=dict(platform="gpu" if cuda else device.type,
                    kind=torch.cuda.get_device_name(device) if cuda
                    else device.type,
                    count=1, memory_peak_bytes=int(max(peak, setup_peak))
                    if cuda else 0))
    if tr is not None:
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = dict(device_ops=tr["device_ops"],
                                idle_gaps=tr["idle_gaps"])
    if after is not None:
        out["after"] = after(path, st, rec)
    out["checks"] = {name: {"value": float(v), "limit": float(lim)}
                     for name, v, lim in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_started = time.monotonic() - _process_age_s()
    chips = common.workload(common.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t_started=t_started)
    found = common.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
