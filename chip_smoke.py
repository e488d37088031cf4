"""Quickest proof that the PyTorch / CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``src/repro_torch/csrc`` at first use.  Phases, one line
each with its timings:

  1. platform   torch / CUDA versions, the card's name and power limit
  2. build      nvcc of every kernel source, with its wall time
  3. era_step   the fused GD-step kernel against its plain version at the
                paper's width (U=1250, M=250, N=5, B=2), one step
  4. noma_rate  the SIC uplink-rate kernel against its plain version at
                the same width
  5. solve      ``solve_batch`` at a small config, B=4, fused step (the
                kernel) against autograd: equal splits and iteration
                counts, Γ within rtol 1e-4
  6. main path  a ``SplitInferenceCluster`` with two paper-width cells
                serving the yolov2 profile: start, submit, observe a
                drifted channel, one admission round; both kernels must
                have been launched in this phase

Then the kernels' JSON line (``max_abs_err`` is the largest absolute
difference over every output; ``max_scaled_err`` the largest of the
quantities the tolerances bound: Γ's relative error and each leaf's
error over its max abs), the card's ``name, power.limit``
line from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero, and so does a machine without a card.
"""
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
# GD step budget of the main path's solves (SolverSpec's default)
MAX_STEPS = 400
# H100 SXM peaks (NVIDIA's data sheet, at the full 700 W power limit):
# HBM bytes/s and float32 CUDA-core FLOP/s
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
# float32 operations per (channel, user) of one era_step call outside the
# in-group SIC sums and the per-AP sums: the expressions of ref.py's
# forward (about 10 per direction) and backward (about 15 per direction)
ERA_ELEMENTWISE_OPS = 50
# per (channel, user) of noma_rate: add, divide, add, log2, multiply
NOMA_ELEMENTWISE_OPS = 5


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps, warm=2):
    """Mean device milliseconds of ``fn`` over ``reps`` back-to-back
    calls (CUDA events), after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def peak_mib(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def scaled_err(got, want):
    """max |got - want| / max |want| over a leaf."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / (want.abs().max() + 1e-30))


def in_group_pairs(assoc, n_aps):
    """(B,) count of same-AP user pairs per channel: the SIC interference
    terms one direction's suffix sums add on each channel."""
    counts = torch.stack([torch.bincount(a, minlength=n_aps) for a in assoc])
    return (counts * (counts - 1) // 2).sum(dim=1).double()


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / F32_FLOPS_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def paper_cells(network, n_cells, device):
    """The paper's published setting (NetworkConfig defaults, §V.A)."""
    cfg = network.NetworkConfig()
    return cfg, [network.make_scenario(
        torch.Generator().manual_seed(SEED + i), cfg, device)
        for i in range(n_cells)]


def random_alloc(era, b, u, m, device):
    g = torch.Generator().manual_seed(SEED + 100)
    rn = lambda *s: torch.randn(s, generator=g)
    return era.Allocation(
        beta_up=torch.softmax(rn(b, u, m), dim=-1).to(device),
        beta_dn=torch.softmax(rn(b, u, m), dim=-1).to(device),
        p=(torch.exp(rn(b, u) * 0.3) * 0.1).to(device),
        p_ap=torch.exp(rn(b, u) * 0.3).to(device),
        r=(1.0 + torch.exp(rn(b, u) * 0.2)).to(device))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card; none is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import era, ligd, network, profiles
    from repro_torch.kernels import _build
    from repro_torch.kernels.era_step import ops as era_ops
    from repro_torch.kernels.era_step import ref as era_ref
    from repro_torch.kernels.era_step.kernel import era_step_fused
    from repro_torch.kernels.noma_rate.kernel import noma_rate
    from repro_torch.kernels.noma_rate.ops import sorted_operands
    from repro_torch.kernels.noma_rate.ref import noma_rate_ref
    from repro_torch.launch import platform
    from repro_torch.serving.cluster import SplitInferenceCluster

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. platform --------------------------------------------------
    desc = platform.describe()
    smi = desc["nvidia_smi"] or "not available"
    log("platform", torch=desc["torch"], cuda=desc["cuda"],
        device=repr(desc["device_name"]), count=desc["device_count"],
        tf32=desc["matmul_allow_tf32"], nvidia_smi=repr(smi))

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(p.name for p in _build._sources()))

    kernels = []
    w = era.Weights()

    # ---- 3. era_step at paper width ------------------------------------
    cfg, scns = paper_cells(network, 2, dev)
    scn_b = network.stack_scenarios(scns)
    prof = profiles.get_profile("yolov2", device=dev)
    b, u, m, n = 2, cfg.n_users, cfg.n_subchannels, cfg.n_aps
    alloc = random_alloc(era, b, u, m, dev)
    s_vec = torch.full((b, u), 4, dtype=torch.int64, device=dev)
    q = torch.full((b, u), 0.4, device=dev)
    aux = era_ops.build_aux(scn_b)
    operands = era_ops._operands(scn_b, prof, s_vec, q, alloc, aux, w)
    out_k = era_step_fused(*operands)
    g_p, grads_p = era_ref.fused_step_math(*operands)
    torch.cuda.synchronize()
    gamma_err = float(((out_k[0] - g_p).abs() / g_p.abs()).max())
    leaf_errs = [scaled_err(k, p) for k, p in zip(out_k[1:], grads_p)]
    if not (gamma_err <= 1e-5 and max(leaf_errs) <= 1e-4):
        raise AssertionError(f"era_step kernel disagrees with its plain "
                             f"version: gamma rel {gamma_err}, scaled "
                             f"leaves {leaf_errs}")
    # bit-identical repeats: the solver's |ΔΓ| stop test relies on it
    again = era_step_fused(*operands)
    if not all(torch.equal(x, y) for x, y in zip(out_k, again)):
        raise AssertionError("era_step kernel is not deterministic")
    k_ms = cuda_ms(lambda: era_step_fused(*operands), reps=50)
    p_ms = cuda_ms(lambda: era_ref.fused_step_math(*operands), reps=3, warm=1)
    k_mib = peak_mib(lambda: era_step_fused(*operands))
    p_mib = peak_mib(lambda: era_ref.fused_step_math(*operands))
    n_bytes = (sum(x.numel() * x.element_size() for x in operands)
               + sum(x.numel() * x.element_size() for x in out_k))
    pairs = in_group_pairs(scn_b.assoc, n)
    n_ops = float((m * (4 * pairs + 8 * u * n + ERA_ELEMENTWISE_OPS * u)
                   ).sum())
    bnd, by = bound_ms(n_bytes, n_ops)
    log("era_step", shape=f"B{b}xM{m}xU{u}xN{n}",
        tol="gamma_rtol_1e-5,leaves_1e-4_of_max",
        gamma_rel_err=f"{gamma_err:.3e}",
        grad_scaled_err=",".join(f"{e:.3e}" for e in leaf_errs),
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}",
        kernel_peak_MiB=f"{k_mib:.1f}", plain_peak_MiB=f"{p_mib:.1f}",
        launches=era_step_fused.launches)
    kernels.append(dict(
        name="era_step", route="cuda",
        source="src/repro_torch/csrc/era_step.cu",
        replaces="src/repro/kernels/era_step/kernel.py:231",
        max_abs_err=max(float((k - p).abs().max())
                        for k, p in zip(out_k, (g_p,) + tuple(grads_p))),
        max_scaled_err=max([gamma_err] + leaf_errs), ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    del out_k, g_p, grads_p, again

    # ---- 4. noma_rate at paper width, one cell (as build_schedule) ------
    args = sorted_operands(scns[0], alloc.beta_up[0], alloc.p[0])
    r_k = noma_rate(*args)
    r_p = noma_rate_ref(*args)
    torch.cuda.synchronize()
    rate_err = scaled_err(r_k, r_p)
    if not rate_err <= 1e-5:
        raise AssertionError(f"noma_rate kernel disagrees with its plain "
                             f"version: scaled err {rate_err}")
    k_ms = cuda_ms(lambda: noma_rate(*args), reps=50)
    p_ms = cuda_ms(lambda: noma_rate_ref(*args), reps=3, warm=1)
    n_bytes = (sum(x.numel() * x.element_size() for x in args)
               + r_k.numel() * r_k.element_size())
    n_ops = float(m * (pairs[0] + NOMA_ELEMENTWISE_OPS * u))
    bnd, by = bound_ms(n_bytes, n_ops)
    log("noma_rate", shape=f"B1xM{m}xU{u}", rate_scaled_err=f"{rate_err:.3e}",
        tol="1e-5_of_max",
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by,
        MB_moved=f"{n_bytes / 1e6:.2f}",
        kernel_peak_MiB=f"{peak_mib(lambda: noma_rate(*args)):.1f}",
        plain_peak_MiB=f"{peak_mib(lambda: noma_rate_ref(*args)):.1f}",
        launches=noma_rate.launches)
    kernels.append(dict(
        name="noma_rate", route="cuda",
        source="src/repro_torch/csrc/noma_rate.cu",
        replaces="src/repro/kernels/noma_rate/kernel.py:52",
        max_abs_err=float((r_k - r_p).abs().max()),
        max_scaled_err=rate_err, ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    del r_k, r_p, args, operands, aux, scn_b, alloc

    # ---- 5. solve_batch, fused (kernel) against autograd ---------------
    t0 = time.perf_counter()
    small = network.small_config(n_users=12, n_subchannels=6)
    sscns = [network.make_scenario(torch.Generator().manual_seed(50 + i),
                                   small, dev) for i in range(4)]
    nin = profiles.get_profile("nin", device=dev)
    qs = torch.full((4, small.n_users), 0.4, device=dev)
    spec = ligd.SolverSpec(tol=0.0, max_steps=40, per_user_split=True)
    o_f = ligd.solve_batch(sscns, nin, qs, w, spec=spec)
    o_a = ligd.solve_batch(sscns, nin, qs, w,
                           spec=spec.replace(step_impl="autograd"))
    for x, y in zip(o_f, o_a):
        np.testing.assert_array_equal(x.s, y.s)
        np.testing.assert_array_equal(x.iters_by_layer, y.iters_by_layer)
        np.testing.assert_allclose(x.gamma_by_layer, y.gamma_by_layer,
                                   rtol=1e-4)
    g_rel = max(float(np.max(np.abs(x.gamma_by_layer - y.gamma_by_layer)
                             / np.abs(y.gamma_by_layer)))
                for x, y in zip(o_f, o_a))
    log("solve", cells=4, users=small.n_users, channels=small.n_subchannels,
        splits_equal=True, iters_equal=True, gamma_rel_err=f"{g_rel:.3e}",
        seconds=f"{time.perf_counter() - t0:.2f}")

    # ---- 6. the main path ---------------------------------------------
    spec = ligd.SolverSpec(backend="chunked", per_user_split=True,
                           max_steps=MAX_STEPS)
    cluster = SplitInferenceCluster(None, None, prof, spec=spec)
    a_id, b_id = (cluster.add_cell(s) for s in scns)
    drifted = network.evolve_scenario(
        scns[1], torch.Generator().manual_seed(SEED + 200), rho=0.5)
    era_step_fused.launches = 0
    noma_rate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    v_boot = cluster.start(threaded=False)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    boot_launches = era_step_fused.launches
    boot_iters = sum(cluster.last_outcome(c).total_iters
                     for c in (a_id, b_id))
    for user, q_s in ((3, 0.25), (17, 0.3), (400, 0.2)):
        cluster.submit(a_id, user=user, q_s=q_s)
    drift = cluster.observe(b_id, drifted)
    t0 = time.perf_counter()
    rnd = cluster.step()
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    launches = {"era_step": era_step_fused.launches,
                "noma_rate": noma_rate.launches}
    round_launches = launches["era_step"] - boot_launches
    if v_boot != 1 or rnd is None or cluster.schedule_version != 2:
        raise AssertionError(f"expected versions 1 then 2, got {v_boot} "
                             f"and {cluster.schedule_version}")
    for cid in (a_id, b_id):
        sched = cluster.installed_schedule(cid)
        for field, val in vars(sched).items():
            arr = np.asarray(val, np.float64)
            if not np.all(np.isfinite(arr)):
                raise AssertionError(f"cell {cid}: {field} is not finite")
        if sched.split.shape != (cfg.n_users,):
            raise AssertionError(f"cell {cid}: split shape "
                                 f"{sched.split.shape}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    cluster.stop()
    log("main_path", cells=2, shape=f"U{cfg.n_users}xM{cfg.n_subchannels}"
        f"xN{cfg.n_aps}", profile="yolov2", max_steps=MAX_STEPS,
        bootstrap_s=f"{t_boot:.3f}", bootstrap_gd_iters=boot_iters,
        bootstrap_steps=boot_launches,
        bootstrap_ms_per_step=f"{t_boot / boot_launches * 1e3:.3f}",
        drift=f"{drift:.4f}", round_cells=",".join(map(str, rnd.cells)),
        round_s=f"{t_round:.3f}", round_gd_iters=rnd.total_iters,
        round_steps=round_launches,
        round_ms_per_step=f"{t_round / max(round_launches, 1) * 1e3:.3f}",
        versions=f"{v_boot}->{cluster.schedule_version}",
        launches=json.dumps(launches).replace(" ", ""))

    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "max_scaled_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order}
                                  for k in kernels]}))
    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
