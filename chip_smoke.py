"""Quickest proof that the PyTorch / CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); builds the port's
kernels from ``src/repro_torch/csrc`` at first use.  Phases, one line
each with its timings:

  1. platform   torch / CUDA versions, the card's name and power limit
  2. build      nvcc of every kernel source, with its wall time
  3. era_step   the fused GD-step kernel against its plain version at the
                paper's width (U=1250, M=250, N=5, B=2), one step; its
                five launches' device time from the profiler (the kernel's
                ``ms``), the CUDA-event time of a Python call
                (``event_ms``) and the wrapper's host time per call
  4. noma_rate  the SIC uplink-rate kernel against its plain version at
                the same width; its launch's device time from the profiler
                (the kernel's ``ms``), the CUDA-event time of a Python call
                (``event_ms``), the wrapper's host time per call and that
                of its ordering check alone
  5. solve      ``solve_batch`` at a small config, B=4, fused step (the
                kernel) against autograd: equal splits and iteration
                counts, Γ within rtol 1e-4
  6. main path  a ``SplitInferenceCluster`` with two paper-width cells
                serving the yolov2 profile: start, submit, observe a
                drifted channel, one admission round; both kernels must
                have been launched in this phase
  7. flash_attention  the attention kernel against its plain version and
                against ``scaled_dot_product_attention`` (the library
                yardstick) at recurrentgemma-2b's local-attention shape
                (B=2, S=4096, H=10, K=1, D=256, window 2048, bf16), at the
                model path's shape (B=16, S=512, the same heads), at
                mixtral-8x22b's (B=2, S=4608, H=48, K=8, D=128, window
                4096), and in float32 at S=512; each bf16 case is held
                against the plain version in bf16 and in float32; the
                bf16 kernel's achieved TFLOP/s at every shape, and the
                registers and spills of every instantiation (ptxas), none
                of which may spill
  8. rglru_scan  the RG-LRU scan kernel against its plain sequential
                version at the model path's shape (B=16, L=512, D=2560)
  9. model path  recurrentgemma-2b at full width and depth in bf16, served
                by a ``SplitInferenceCluster`` of two cells: start, then
                ``serve_round(decode_steps=8)``; both model kernels must
                have been launched in that call, every user served, and a
                split group's device + edge logits must equal the fused
                forward, and the fused (kernel) logits of its rows must
                agree with a plain forward (naive attention, the plain
                sequential scan) on the card
 10. ssd        the SSD scan kernel against its plain chunked version at
                the model path's shape (B=16, L=2048, H=48, P=64, N=128,
                chunk 256, bf16 x/B/C, A = -(1..48)), in float32 at
                (2, 512, 4, 64, 128, 256), and at a ragged L=2000 against
                the plain sequential scan; its three launches' device time
                from the profiler (the kernel's ``ms``; ``event_ms`` the
                CUDA-event time), TFLOP/s on the work the function needs,
                the bytes its chunk states move, and the registers and
                spills of every instantiation (ptxas), none of which may
                spill
 11. mamba2 path  mamba2-780m at full width and depth in bf16, served by
                a ``SplitInferenceCluster`` of two cells with 2048-token
                requests: the ssd kernel must have been launched in
                ``serve_round``, every user served, device + edge logits
                equal to the fused forward; for a group's rows against a
                plain forward (``impl="naive"``: the plain chunked scan),
                the bf16 logits within twice the spread between two plain
                forwards (chunk 256 and 128), each block's kernel output
                within 2e-2 of its plain output on the same input, and
                the float32 model's logits within 2e-2 of max |logit|;
                each bf16 path's distance from a plain forward whose SSD
                runs in float64 is logged
 12. mixtral path  mixtral-8x22b at published width (8 experts top-2,
                GQA 48/8, window 4096, bf16) with depth cut to 6 of 56
                layers, served by a ``SplitInferenceCluster`` of two
                cells of 8 users with 4608-token requests: flash_attention
                launched, every user served, the chunked expert loop taken
                (capacity 16,384 > C_CHUNK); the slots dropped in prefill
                and decode; device + edge logits equal to the fused
                forward; against a plain forward (naive attention) on 2
                rows, with each MoE call's routes (expert, keep) recorded:
                the logits and the route flips within the larger of 2x
                those of a second plain path one bf16 ulp away (its
                probabilities kept in float32 through P·V) and 2e-2 / 1%;
                on each block's own input at most 1% of routes flipped
                and the agreeing tokens' outputs within 2e-2; the float32
                model (a layer at a time) with at most 1% flipped and its
                agreeing tokens' logits within 2e-2
 13. load generator  ``run_load`` at 8 cells x 16 users: a flash crowd of
                5000 arrivals with the ``QoSGovernor`` (a ``FileSink`` on
                its bus) and without it, the same arrivals, the governed
                run shedding spike lanes and the JSONL lines equal to the
                bus's events; a mobility trace with handovers by
                ``move_user`` and by leave+rejoin; era_step and noma_rate
                launched
 14. launcher   ``repro_torch.launch.serve.main`` on the card: the async
                cluster with the governor, churn and a trace on the tiny
                mixtral (the trace holds bootstrap, admission_round,
                serve_round, cell_join and cell_leave), then the one-cell
                mode on the tiny dbrx

Then the kernels' JSON line (``max_abs_err`` is the largest absolute
difference over every output; ``max_scaled_err`` the largest of the
quantities the tolerances bound: Γ's relative error and each leaf's
error over its max abs; ``launches`` the count on each kernel's first
path, ``launches_by_path`` its count on every path that runs it; flash's
``mixtral_*`` keys its times at mixtral's shape), the card's ``name,
power.limit``
line from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero, and so does a machine without a card.
"""
import contextlib
import copy
import io
import json
import os
import re
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

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
# H100 SXM dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W)
BF16_FLOPS_S = 989e12
# one bf16 ulp of the output (2^-7 of it; rounding alone is at most half)
# plus a small absolute term for float32 summation order near zero
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-4
# the model path's serving round (phase 9)
SERVE_USERS, SERVE_SEQ, DECODE_STEPS = 16, 512, 8
# the mamba2 path's request length (phase 11): 8 chunks of its 256
MAMBA_SEQ = 2048
# phase 11's bf16 logits, kernel against the plain path, as a multiple of
# the spread between two plain paths (chunk 256 and 128): at 48 layers
# that spread is ~5e-2 of max |logit|, above PLAIN_LOGIT_TOL, which phase
# 11 holds per block and for the float32 model instead
MAMBA_SPREAD_FACTOR = 2.0
# bf16 logits of the full model, kernels against the plain path, as a
# share of max |logit|: each attention layer's output may differ by about
# a bf16 ulp (the plain path rounds probabilities to bf16 before P·V)
PLAIN_LOGIT_TOL = 2e-2
# the mixtral path (phase 12): 8 users a cell of 4608-token requests, past
# the 4096 window; depth cut to 6 of 56 layers (the weights' 30.9 GB)
MOE_USERS, MOE_SEQ, MIXTRAL_LAYERS = 8, 4608, 6
# rows of a group held to the plain path (2 x 4608 tokens: its float32
# attention scores take 8.2 GB)
MOE_PLAIN_ROWS = 2
# the largest share of (token, slot) routes (expert and keep) that may
# differ between the kernel and the plain path on the same block input: a
# bf16 ulp after attention can flip a near-tie in the router
MOE_FLIP_MAX = 0.01
# the load generator (phase 13): arrivals pushed per run
LOAD_USERS, MOBILITY_USERS = 5000, 2000


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


def launch_breakdown(fn, reps, names):
    """Where one call of ``fn`` spends its time: the device ms of each of
    its kernel launches ``names`` (in launch order, as ``short_name``
    gives them), from the profiler's kernel records averaged over the
    calls whose records are complete, their sum, the host ms a call takes
    to enqueue them (no synchronisation inside the timed loop), and how
    many of the ``reps`` calls had complete records.  Records of other
    kernels (a wrapper's own torch ops) are left out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ker = sorted((e for e in trace.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    seq = [(short_name(e.name), e.time_range.elapsed_us() / 1e3)
           for e in ker if short_name(e.name) in names]
    # a profiler session may drop records: count the runs of ``names``
    calls, i, k = [], 0, len(names)
    while i + k <= len(seq):
        if [n_ for n_, _ in seq[i:i + k]] == list(names):
            calls.append([t for _, t in seq[i:i + k]])
            i += k
        else:
            i += 1
    if 2 * len(calls) < reps:
        raise AssertionError(f"{len(calls)} of {reps} calls have complete "
                             f"kernel records ({len(ker)} records)")
    launches = [(n_, sum(c[j] for c in calls) / len(calls))
                for j, n_ in enumerate(names)]
    return launches, sum(t for _, t in launches), host_ms, len(calls)


def short_name(name):
    """"void (anonymous namespace)::ssd_out_kernel<64, 128>(...)" ->
    "ssd_out_kernel"."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


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


def bound_ms(n_bytes, n_ops, peak_flops_s=F32_FLOPS_S):
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / peak_flops_s * 1e3
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
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core import era, ligd, network, profiles
    from repro_torch.kernels import _build
    from repro_torch.kernels.era_step import ops as era_ops
    from repro_torch.kernels.era_step import ref as era_ref
    from repro_torch.kernels.era_step.kernel import era_step_fused
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bhsd, flash_attention_bshd)
    from repro_torch.kernels.noma_rate.kernel import noma_rate
    from repro_torch.kernels.noma_rate.ops import sorted_operands
    from repro_torch.kernels.noma_rate.ref import noma_rate_ref
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd.kernel import ssd_scan
    from repro_torch.launch import platform, serve
    from repro_torch.loadgen import make_trace, run_load
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import blocks
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer
    from repro_torch.models.common import Params, positions_for
    from repro_torch.serving import QoSGovernor, split_runtime
    from repro_torch.serving.cluster import SplitInferenceCluster
    from repro_torch.telemetry import FileSink, TelemetryBus

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
    # each kernel's launches on every path that runs it, each path's counts
    # set to 0 just before it is driven and read just after
    by_path = {n: {} for n in ("era_step", "noma_rate", "flash_attention",
                               "rglru_scan", "ssd")}
    KERNEL_FNS = {"era_step": era_step_fused, "noma_rate": noma_rate,
                  "flash_attention": flash_attention_bshd}
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
    ev_ms = cuda_ms(lambda: era_step_fused(*operands), reps=50)
    # the kernel's own time: its launches' device time from the profiler
    # (CUDA events around the Python call also count the wrapper's host
    # time once that exceeds the device's)
    per_launch, k_ms, host_ms, _ = launch_breakdown(
        lambda: era_step_fused(*operands), reps=20,
        names=("pass0_kernel", "colsum_kernel", "tail_kernel",
               "pass1_kernel", "colsum_kernel"))
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
        kernel_device_ms=f"{k_ms:.4f}", kernel_event_ms=f"{ev_ms:.4f}",
        host_ms_per_call=f"{host_ms:.4f}",
        launch_device_ms=json.dumps([[n_, round(t, 4)] for n_, t in
                                     per_launch]).replace(" ", ""),
        plain_ms=f"{p_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}",
        kernel_peak_MiB=f"{k_mib:.1f}", plain_peak_MiB=f"{p_mib:.1f}",
        launches=era_step_fused.launches)
    kernels.append(dict(
        name="era_step", route="cuda",
        source="src/repro_torch/csrc/era_step.cu",
        replaces="src/repro/kernels/era_step/kernel.py:231",
        max_abs_err=max(float((k - p).abs().max())
                        for k, p in zip(out_k, (g_p,) + tuple(grads_p))),
        max_scaled_err=max([gamma_err] + leaf_errs), ms=k_ms, event_ms=ev_ms,
        plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None))
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
    ev_ms = cuda_ms(lambda: noma_rate(*args), reps=50)
    # the kernel's own device time (the profiler), apart from the wrapper's
    # host time, which waits for its ordering check's result every call
    _, k_ms, host_ms, n_prof = launch_breakdown(
        lambda: noma_rate(*args), reps=20, names=("noma_rate_kernel",))
    gend = args[2]
    t0 = time.perf_counter()
    for _ in range(20):
        bool((gend[..., 1:] < gend[..., :-1]).any())
    check_ms = (time.perf_counter() - t0) / 20 * 1e3
    p_ms = cuda_ms(lambda: noma_rate_ref(*args), reps=3, warm=1)
    n_bytes = (sum(x.numel() * x.element_size() for x in args)
               + r_k.numel() * r_k.element_size())
    n_ops = float(m * (pairs[0] + NOMA_ELEMENTWISE_OPS * u))
    bnd, by = bound_ms(n_bytes, n_ops)
    log("noma_rate", shape=f"B1xM{m}xU{u}", rate_scaled_err=f"{rate_err:.3e}",
        tol="1e-5_of_max",
        kernel_device_ms=f"{k_ms:.4f}", kernel_event_ms=f"{ev_ms:.4f}",
        host_ms_per_call=f"{host_ms:.4f}",
        order_check_host_ms=f"{check_ms:.4f}", profiled_calls=n_prof,
        plain_ms=f"{p_ms:.4f}",
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
        max_scaled_err=rate_err, ms=k_ms, event_ms=ev_ms, plain_ms=p_ms,
        bound_ms=bnd, bound_by=by, library_ms=None))
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
    for name, count in launches.items():
        by_path[name]["solver"] = count
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

    # ---- 7. flash_attention --------------------------------------------
    def attn_inputs(b, s_len, h, kh, d, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, s_len, h, d), (b, s_len, kh, d),
                              (b, s_len, kh, d))]

    def folded(q, k, v):
        """The kernel's (B·H, S, D) operands, folded once outside the
        timed calls."""
        fold = lambda x: x.transpose(1, 2).reshape(
            -1, x.shape[1], x.shape[3]).contiguous()
        return fold(q), fold(k), fold(v)

    def attn_check(q, k, v, window, tol):
        """The kernel against its plain version on the same inputs, within
        ``tol`` absolute plus relative; bf16 inputs are also held against
        the plain version in float32 within one bf16 ulp of the output
        (the kernel's sums are float32, P enters P·V as its bf16 head and
        remainder, and only its output is rounded).
        Returns the kernel's output, its max abs difference from the plain
        version, that version's max |o|, and the float32 difference."""
        out_k = fa_ops.flash_attention(q, k, v, causal=True, window=window)
        out_p = fa_ref.attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        diff = (out_k.float() - out_p.float()).abs()
        if not bool((diff <= tol + tol * out_p.float().abs()).all()):
            raise AssertionError(f"flash_attention kernel disagrees with its "
                                 f"plain version: max abs err "
                                 f"{float(diff.max())}, tolerance {tol}")
        err32 = None
        if q.dtype == torch.bfloat16:
            out_32 = fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                          causal=True, window=window)
            d32 = (out_k.float() - out_32).abs()
            if not bool((d32 <= BF16_ULP_ATOL
                         + BF16_ULP_RTOL * out_32.abs()).all()):
                raise AssertionError(
                    f"flash_attention kernel (bf16) is more than one bf16 "
                    f"ulp from its plain version in float32: max abs err "
                    f"{float(d32.max())}")
            err32 = float(d32.max())
            del out_32, d32
        return out_k, float(diff.max()), float(out_p.float().abs().max()), \
            err32

    # recurrentgemma-2b's local attention: H=10, K=1, D=256, window 2048
    b, s_len, h, kh, d, win = 2, 4096, 10, 1, 256, 2048
    q, k, v = attn_inputs(b, s_len, h, kh, d, torch.bfloat16, SEED + 300)
    out_k, fa_err, fa_max, fa_err32 = attn_check(q, k, v, win, 2e-2)
    pos = torch.arange(s_len, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    sdpa_err = float((sdpa().transpose(1, 2).float() - out_k.float())
                     .abs().max())
    fq, fk, fv = folded(q, k, v)
    k_ms = cuda_ms(lambda: flash_attention_bhsd(fq, fk, fv, causal=True,
                                                window=win), reps=20)
    ops_ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True,
                                                    window=win), reps=20)
    p_ms = cuda_ms(lambda: fa_ref.attention_ref(q, k, v, causal=True,
                                                window=win), reps=3, warm=1)
    lib_ms = cuda_ms(sdpa, reps=20)
    pairs = b * h * sum(min(i + 1, win) for i in range(s_len))
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, out_k))
    bnd, by = bound_ms(n_bytes, 4.0 * d * pairs, BF16_FLOPS_S)
    del out_k, qt, kt, vt, fq, fk, fv
    # the model path's shape: 16 users x 512 tokens, window 2048 (bf16)
    q, k, v = attn_inputs(SERVE_USERS, SERVE_SEQ, h, kh, d, torch.bfloat16,
                          SEED + 302)
    _, fa_err_main, fa_max_main, fa_err32_main = attn_check(q, k, v, win,
                                                            2e-2)
    qm, km, vm = folded(q, k, v)
    main_ms = cuda_ms(lambda: flash_attention_bhsd(qm, km, vm, causal=True,
                                                   window=win), reps=20)
    main_flop = 4.0 * d * SERVE_USERS * h * sum(
        min(i + 1, win) for i in range(SERVE_SEQ))
    del q, k, v, qm, km, vm
    # float32 at S=512, a window that binds
    q32, k32, v32 = attn_inputs(2, 512, h, kh, d, torch.float32, SEED + 301)
    _, fa_err32_s512, _, _ = attn_check(q32, k32, v32, 128, 2e-5)
    del q32, k32, v32
    # mixtral-8x22b's sliding-window attention: 48 q heads over 8 kv heads
    # (GQA group 6), D=128, window 4096 binding past it (bf16)
    mx = dict(b=2, s_len=MOE_SEQ, h=48, kh=8, d=128, win=4096)
    q, k, v = attn_inputs(mx["b"], mx["s_len"], mx["h"], mx["kh"], mx["d"],
                          torch.bfloat16, SEED + 303)
    out_mx, mx_err, mx_max, mx_err32 = attn_check(q, k, v, mx["win"], 2e-2)
    pos = torch.arange(mx["s_len"], device=dev)
    mask = (pos[None, :] <= pos[:, None]) & (
        pos[None, :] > pos[:, None] - mx["win"])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
    mx_sdpa_err = float((sdpa().transpose(1, 2).float() - out_mx.float())
                        .abs().max())
    mx_lib_ms = cuda_ms(sdpa, reps=20)
    # the kernel reads the model layout (B, S, H, D) at its strides
    mx_ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, causal=True,
                                                 window=mx["win"]), reps=20)
    mx_plain_ms = cuda_ms(lambda: fa_ref.attention_ref(
        q, k, v, causal=True, window=mx["win"]), reps=3, warm=1)
    mx_pairs = mx["b"] * mx["h"] * sum(min(i + 1, mx["win"])
                                       for i in range(mx["s_len"]))
    mx_flop = 4.0 * mx["d"] * mx_pairs
    mx_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, out_mx))
    mx_bnd, mx_by = bound_ms(mx_bytes, mx_flop, BF16_FLOPS_S)
    del q, k, v, qt, kt, vt, out_mx, mask
    # registers and spills of every instantiation (ptxas -v of this build)
    fa_usage = {re.sub(r"^_ZN\w*?flash_attention", "", name)[:48]: use
                for name, use in _build.ptxas_usage("flash_attention").items()}
    spilled = {n_: u_ for n_, u_ in fa_usage.items() if u_[1] or u_[2]}
    if spilled:
        raise AssertionError(f"flash_attention instantiations spill "
                             f"(registers, store, load bytes): {spilled}")
    log("flash_attention", shape=f"B{b}xS{s_len}xH{h}xK{kh}xD{d}",
        window=win, dtype="bf16", tol="2e-2_abs+rel",
        max_abs_err=f"{fa_err:.3e}", kernel_ms=f"{k_ms:.4f}",
        with_layout_ms=f"{ops_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        sdpa_ms=f"{lib_ms:.4f}", sdpa_max_abs_diff=f"{sdpa_err:.3e}",
        f32_plain_tol=f"{BF16_ULP_RTOL:.4g}_rel+{BF16_ULP_ATOL:g}_abs",
        f32_plain_max_abs_err=f"{fa_err32:.3e}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}",
        GFLOP=f"{4.0 * d * pairs / 1e9:.1f}",
        TFLOP_s=f"{4.0 * d * pairs / k_ms / 1e9:.1f}",
        main_path_shape=f"B{SERVE_USERS}xS{SERVE_SEQ}",
        main_path_TFLOP_s=f"{main_flop / main_ms / 1e9:.1f}",
        main_path_max_abs_err=f"{fa_err_main:.3e}",
        main_path_f32_plain_max_abs_err=f"{fa_err32_main:.3e}",
        main_path_ms=f"{main_ms:.4f}",
        f32_S512_window128_max_abs_err=f"{fa_err32_s512:.3e}",
        f32_tol="2e-5",
        ptxas_regs_spill_st_ld=json.dumps(fa_usage).replace(" ", ""))
    log("flash_attention_mixtral",
        shape="B{b}xS{s_len}xH{h}xK{kh}xD{d}".format(**mx), window=mx["win"],
        dtype="bf16", tol="2e-2_abs+rel", max_abs_err=f"{mx_err:.3e}",
        f32_plain_tol=f"{BF16_ULP_RTOL:.4g}_rel+{BF16_ULP_ATOL:g}_abs",
        f32_plain_max_abs_err=f"{mx_err32:.3e}", kernel_ms=f"{mx_ms:.4f}",
        plain_ms=f"{mx_plain_ms:.4f}", sdpa_ms=f"{mx_lib_ms:.4f}",
        sdpa_max_abs_diff=f"{mx_sdpa_err:.3e}", bound_ms=f"{mx_bnd:.4f}",
        bound_by=mx_by, MB_moved=f"{mx_bytes / 1e6:.2f}",
        GFLOP=f"{mx_flop / 1e9:.1f}", TFLOP_s=f"{mx_flop / mx_ms / 1e9:.1f}",
        ptxas_D128_regs_spill_st_ld=json.dumps(
            {n_: u_ for n_, u_ in fa_usage.items() if "Li128E" in n_}
        ).replace(" ", ""))
    kernels.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:102",
        max_abs_err=max(fa_err, fa_err_main, mx_err),
        max_scaled_err=max(fa_err / fa_max, fa_err_main / fa_max_main,
                           mx_err / mx_max),
        ms=k_ms, plain_ms=p_ms,
        bound_ms=bnd, bound_by=by, library_ms=lib_ms,
        mixtral_shape="B{b}xS{s_len}xH{h}xK{kh}xD{d}_w{win}".format(**mx),
        mixtral_ms=mx_ms, mixtral_plain_ms=mx_plain_ms,
        mixtral_bound_ms=mx_bnd, mixtral_library_ms=mx_lib_ms))

    # ---- 8. rglru_scan at the model path's shape --------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 400)
    shape = (SERVE_USERS, SERVE_SEQ, 2560)
    a_s = torch.empty(shape, device=dev).uniform_(0.7, 0.999, generator=g)
    b_s = torch.randn(shape, generator=g, device=dev) * 0.1
    h_k = rglru_scan(a_s, b_s)
    h_p = scan_ref.linear_scan_sequential(a_s, b_s)
    torch.cuda.synchronize()
    scan_err = scaled_err(h_k, h_p)
    if not scan_err <= 1e-5:
        raise AssertionError(f"rglru_scan kernel disagrees with its plain "
                             f"version: scaled err {scan_err}")
    k_ms = cuda_ms(lambda: rglru_scan(a_s, b_s), reps=50)
    p_ms = cuda_ms(lambda: scan_ref.linear_scan_sequential(a_s, b_s), reps=3,
                   warm=1)
    n_bytes = 3 * a_s.numel() * a_s.element_size()
    bnd, by = bound_ms(n_bytes, 2.0 * a_s.numel())
    log("rglru_scan", shape="B{}xL{}xD{}".format(*shape), tol="1e-5_of_max",
        scaled_err=f"{scan_err:.3e}", bit_identical=torch.equal(h_k, h_p),
        kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}")
    kernels.append(dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:47",
        max_abs_err=float((h_k - h_p).abs().max()), max_scaled_err=scan_err,
        ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    del a_s, b_s, h_k, h_p

    # ---- helpers of the model paths (phases 9 and 11) --------------------
    def check_served(out, ids, mcfg, n_users=SERVE_USERS):
        """Every user of every cell served, tokens in range, each latency
        the sum of its parts.  The range is the LM head's: like the JAX
        package's engine, the port takes the argmax over the padded vocab
        (mamba2-780m: 50280 padded to 50432), so a padded token is a legal
        output of both."""
        if sorted(out) != sorted(ids):
            raise AssertionError(f"served cells {sorted(out)}, expected "
                                 f"{ids}")
        for cid, res in out.items():
            if [r.user for r in res] != list(range(n_users)):
                raise AssertionError(f"cell {cid}: users "
                                     f"{[r.user for r in res]}")
            for r in res:
                if r.tokens_out.shape != (DECODE_STEPS,) or not (
                        0 <= r.tokens_out.min()
                        and r.tokens_out.max() < mcfg.padded_vocab):
                    raise AssertionError(f"cell {cid} user {r.user}: tokens "
                                         f"{r.tokens_out}")
                if r.latency_s != (r.t_device + r.t_uplink + r.t_edge
                                   + r.t_downlink) or not r.latency_s > 0:
                    raise AssertionError(f"cell {cid} user {r.user}: latency "
                                         f"{r.latency_s} is not its parts' "
                                         f"sum")

    def check_split(model, mcfg, rows, split, fused):
        """Device + edge logits against the fused forward at the group's
        split (and mid-depth when that group is edge- or device-only): a
        check of the split wiring.  Returns {split: error over max
        |logit|}."""
        if not bool(torch.isfinite(fused).all()):
            raise AssertionError("fused logits are not finite")
        errs = {}
        for s_ in [split] + ([mcfg.n_layers // 2]
                             if split in (0, mcfg.n_layers) else []):
            x, pos_ = split_runtime.device_forward(model, mcfg, rows, s_,
                                                   impl="kernel")
            lg = split_runtime.edge_forward(model, mcfg, x, pos_, s_,
                                            impl="kernel")
            errs[s_] = float((lg - fused).abs().max() / fused.abs().max())
            if not errs[s_] <= 1e-2:
                raise AssertionError(f"split {s_}: device+edge logits differ "
                                     f"from the fused forward by "
                                     f"{errs[s_]} of max |logit|")
            del x, lg
        return errs

    def profiled_round(cluster, by_cell):
        """Where a round's device time goes: a second, profiled round.
        Returns (wall s, device-busy s, the top eight kernel rows)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            cluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t0
        # kernel rows only: an operator's row repeats its kernels' time
        events = [e for e in trace.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in events) / 1e6
        top = sorted(events, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        return t_wall, busy, top

    # ---- 9. the model path -------------------------------------------------
    # Users and tokens are cut (16 x 512) because the LM head materialises
    # (rows, S, 256000) float32 logits, as the JAX package does: 8.4 GB for
    # one split group of 16 users, and again for the decode prefill.  Width
    # and depth are the published ones; weights are random from SEED.
    t_phase = time.perf_counter()
    mcfg = configs.get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    model = transformer.init(torch.Generator().manual_seed(SEED), mcfg, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ncfg = network.small_config(n_users=SERVE_USERS, n_subchannels=8)
    mscns = [network.make_scenario(
        torch.Generator().manual_seed(SEED + 500 + i), ncfg, dev)
        for i in range(2)]
    mprof = profiles.transformer_profile(mcfg, seq=SERVE_SEQ, device=dev)
    mcluster = SplitInferenceCluster(
        model, mcfg, mprof,
        spec=ligd.SolverSpec(backend="chunked", per_user_split=True))
    ids = [mcluster.add_cell(x) for x in mscns]
    t0 = time.perf_counter()
    mcluster.start(threaded=False)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    tokens = torch.randint(0, mcfg.vocab_size,
                           (2, SERVE_USERS, SERVE_SEQ), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED + 600)
                           ).numpy()
    by_cell = {c: tokens[i] for i, c in enumerate(ids)}
    flash_attention_bshd.launches = 0
    rglru_scan.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches["flash_attention"] = flash_attention_bshd.launches
    launches["rglru_scan"] = rglru_scan.launches
    for name in ("flash_attention", "rglru_scan"):
        by_path[name]["recurrentgemma"] = launches[name]
    for name in ("flash_attention", "rglru_scan"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the model path")
    check_served(out, ids, mcfg)
    groups = {int(c): {s_: len(u) for s_, u in
                       mcluster.installed_schedule(c).groups().items()}
              for c in ids}
    # split == fused for one split group (and mid-depth when that group
    # is edge- or device-only), up to 4 of its users
    split, users = next(iter(mcluster.installed_schedule(ids[0])
                             .groups().items()))
    rows = torch.as_tensor(tokens[0][users[:4]], device=dev)
    fused, _ = transformer.forward(model, mcfg, rows, impl="kernel")
    split_errs = check_split(model, mcfg, rows, split, fused)
    # the same rows through the plain path: naive attention and the plain
    # sequential scan, with neither kernel launched
    kernel_scan = rglru_mod.linear_scan
    rglru_mod.linear_scan = scan_ref.linear_scan_sequential
    n_fa, n_scan = flash_attention_bshd.launches, rglru_scan.launches
    try:
        plain, _ = transformer.forward(model, mcfg, rows, impl="naive")
    finally:
        rglru_mod.linear_scan = kernel_scan
    if (flash_attention_bshd.launches, rglru_scan.launches) != (n_fa, n_scan):
        raise AssertionError("the plain forward launched a kernel")
    plain_err = float((plain - fused).abs().max() / plain.abs().max())
    if not plain_err <= PLAIN_LOGIT_TOL:
        raise AssertionError(f"kernel logits differ from the plain path's by "
                             f"{plain_err} of max |logit|, tolerance "
                             f"{PLAIN_LOGIT_TOL}")
    del fused, plain
    t_prof, busy_s, top = profiled_round(mcluster, by_cell)
    mcluster.stop()
    n_tokens = 2 * SERVE_USERS * DECODE_STEPS
    log("model_path", model=mcfg.name, params=transformer.param_count(model),
        d_model=mcfg.d_model, layers=mcfg.n_layers, vocab=mcfg.vocab_size,
        dtype=mcfg.dtype, cells=2, users=SERVE_USERS, seq=SERVE_SEQ,
        decode_steps=DECODE_STEPS, init_s=f"{t_init:.3f}",
        start_s=f"{t_start:.3f}", serve_round_s=f"{t_serve:.3f}",
        tokens_per_s=f"{n_tokens / t_serve:.1f}", peak_GiB=f"{peak_gib:.2f}",
        split_groups=json.dumps(groups).replace(" ", ""),
        split_vs_fused=json.dumps(split_errs).replace(" ", ""),
        kernel_vs_plain=f"{plain_err:.3e}", kernel_vs_plain_tol=PLAIN_LOGIT_TOL,
        launches=json.dumps({n: launches[n] for n in
                             ("flash_attention", "rglru_scan")}
                            ).replace(" ", ""))
    log("model_path_profile", round_s=f"{t_prof:.3f}",
        device_busy_s=f"{busy_s:.3f}",
        device_busy_share=f"{busy_s / t_prof:.3f}",
        top_kernels_ms=json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
             for e in top}),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    del model, mcluster

    # ---- 10. ssd at the model path's shape --------------------------------
    t_phase = time.perf_counter()
    def ssd_inputs(bt, l, h, p, n, dtype, seed):
        """mamba2-780m's operands: dt from a softplus (mean ~0.05, as
        softplus(dt_raw + dt_bias) with the init's dt_bias), A = -(1..h),
        D = 1; x, B and C in ``dtype``."""
        g = torch.Generator(device=dev).manual_seed(seed)
        rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
        x = rn(bt, l, h, p).to(dtype)
        dt = F.softplus(rn(bt, l, h) - 3.0)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
        b, c = (rn(bt, l, n) * 0.5).to(dtype), (rn(bt, l, n) * 0.5).to(dtype)
        return x, dt, a, b, c, torch.ones(h, device=dev)

    def ssd_check(args, chunk, plain, what):
        """The kernel against ``plain`` (float32 math) on the same inputs:
        a float32 y within 1e-4 of max |y|, a bf16 y within one bf16 ulp
        of the output (2^-7 rel + 1e-4 abs); the state within 1e-4 of max
        |state|.  Returns (max abs err, max scaled err)."""
        y_k, s_k = ssd_ops.ssd(*args, chunk=chunk)
        x, dt, a, b, c, d = args
        y_p, s_p = plain(x.float(), dt, a, b.float(), c.float(), d)
        torch.cuda.synchronize()
        dy = (y_k.float() - y_p).abs()
        ds = (s_k - s_p).abs()
        y_max, s_max = float(y_p.abs().max()), float(s_p.abs().max())
        if x.dtype == torch.float32:
            y_ok = float(dy.max()) <= 1e-4 * y_max
        else:
            y_ok = bool((dy <= BF16_ULP_ATOL
                         + BF16_ULP_RTOL * y_p.abs()).all())
        if not (y_ok and float(ds.max()) <= 1e-4 * s_max):
            raise AssertionError(
                f"ssd kernel ({what}) disagrees with its plain version: y "
                f"max abs err {float(dy.max())} (max |y| {y_max}), state "
                f"max abs err {float(ds.max())} (max |state| {s_max})")
        return (max(float(dy.max()), float(ds.max())),
                max(float(dy.max()) / y_max, float(ds.max()) / s_max))

    ssd_shape = (SERVE_USERS, MAMBA_SEQ, 48, 64, 128)
    sargs = ssd_inputs(*ssd_shape, torch.bfloat16, SEED + 900)
    chunked = lambda *a_: ssd_ref.ssd_chunked(*a_, chunk=256)
    ssd_err, ssd_scaled = ssd_check(sargs, 256, chunked, "bf16, model shape")
    y1, s1 = ssd_scan(*sargs, chunk=256)
    y2, s2 = ssd_scan(*sargs, chunk=256)
    if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
        raise AssertionError("ssd kernel is not deterministic")
    del y1, s1, y2, s2
    f32_args = ssd_inputs(2, 512, 4, 64, 128, torch.float32, SEED + 901)
    f32_err, f32_scaled = ssd_check(f32_args, 256, chunked, "f32")
    del f32_args
    # a ragged last chunk (2000 = 7 x 256 + 208) against the sequential
    # recurrence, in float32 at the model's heads
    rag_args = ssd_inputs(2, 2000, 48, 64, 128, torch.float32, SEED + 902)
    rag_err, rag_scaled = ssd_check(rag_args, 256, ssd_ref.ssd_sequential,
                                    "ragged L=2000")
    del rag_args
    ev_ms = cuda_ms(lambda: ssd_scan(*sargs, chunk=256), reps=20)
    per_launch, k_ms, host_ms, n_prof = launch_breakdown(
        lambda: ssd_scan(*sargs, chunk=256), reps=10,
        names=("ssd_states_kernel", "ssd_pass_kernel", "ssd_out_kernel"))
    p_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*sargs, chunk=256), reps=3,
                   warm=1)
    x_s, dt_s, _, b_s, _, _ = sargs
    bt_, l_, h_, p_, n_ = ssd_shape
    n_bytes = (2 * x_s.numel() * x_s.element_size()        # x in, y out
               + dt_s.numel() * 4 + 2 * b_s.numel() * b_s.element_size()
               + bt_ * h_ * p_ * n_ * 4 + 2 * h_ * 4)      # state, a, d
    # the work these inputs need: per (batch, chunk) the causal half of
    # C·Bᵀ; per (batch, head, chunk) the causal half of the weighted sum
    # (and its weight: exp and multiply) and C·S in plus the state update
    rows = [min(256, l_ - c0) for c0 in range(0, l_, 256)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    n_ops = float(bt_ * (2 * n_ * pairs
                         + h_ * ((2 * p_ + 2) * pairs
                                 + 4 * sum(rows) * n_ * p_)))
    bnd, by = bound_ms(n_bytes, n_ops, BF16_FLOPS_S)
    # what the bf16 kernel's three launches move beyond the bound's bytes:
    # the chunk states (written by the first, read and written by the
    # pass, read by the last) and x, read by the first and the last
    st_bytes = bt_ * -(-l_ // 256) * h_ * p_ * n_ * 4
    design_bytes = n_bytes + x_s.numel() * x_s.element_size() + 4 * st_bytes
    # registers and spills of every instantiation (ptxas -v of this build)
    ssd_usage = {re.sub(r"^_ZN\w*?ssd", "", name)[:48]: use
                 for name, use in _build.ptxas_usage("ssd").items()}
    log("ssd", shape="B{}xL{}xH{}xP{}xN{}".format(*ssd_shape), chunk=256,
        dtype="bf16", tol=f"{BF16_ULP_RTOL:.4g}_rel+{BF16_ULP_ATOL:g}_abs"
        "_vs_f32_plain,state_1e-4_of_max",
        max_abs_err=f"{ssd_err:.3e}", scaled_err=f"{ssd_scaled:.3e}",
        f32_B2xL512xH4_scaled_err=f"{f32_scaled:.3e}",
        ragged_L2000_vs_sequential_scaled_err=f"{rag_scaled:.3e}",
        f32_tol="1e-4_of_max", bit_identical_repeat=True,
        kernel_device_ms=f"{k_ms:.4f}", kernel_event_ms=f"{ev_ms:.4f}",
        host_ms_per_call=f"{host_ms:.4f}",
        launch_device_ms=json.dumps([[n_, round(t, 4)] for n_, t in
                                     per_launch]).replace(" ", ""),
        profiled_calls=n_prof, plain_ms=f"{p_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}",
        GFLOP=f"{n_ops / 1e9:.1f}", TFLOP_s=f"{n_ops / k_ms / 1e9:.1f}",
        chunk_state_MB=f"{4 * st_bytes / 1e6:.2f}",
        design_MB_moved=f"{design_bytes / 1e6:.2f}",
        ptxas_regs_spill_st_ld=json.dumps(ssd_usage).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    kernels.append(dict(
        name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:83",
        max_abs_err=max(ssd_err, f32_err, rag_err),
        max_scaled_err=max(ssd_scaled, f32_scaled, rag_scaled), ms=k_ms,
        event_ms=ev_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=None))
    del sargs, x_s, dt_s, b_s
    spilled = {n_: u_ for n_, u_ in ssd_usage.items() if u_[1] or u_[2]}
    if spilled:
        raise AssertionError(f"ssd instantiations spill (registers, store, "
                             f"load bytes): {spilled}")

    # ---- 11. the mamba2 path -----------------------------------------------
    # Users are cut (16 per cell) because the LM head materialises (rows,
    # S, 50432) float32 logits, as the JAX package does: 6.6 GB for one
    # split group of 16 users x 2048 tokens, and again for the decode
    # prefill.  Width, depth and request length (8 chunks) are the
    # published ones; weights are random from SEED.
    t_phase = time.perf_counter()
    mcfg = configs.get_config("mamba2-780m")
    t0 = time.perf_counter()
    model = transformer.init(torch.Generator().manual_seed(SEED), mcfg, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    mscns = [network.make_scenario(
        torch.Generator().manual_seed(SEED + 700 + i), ncfg, dev)
        for i in range(2)]
    mprof = profiles.transformer_profile(mcfg, seq=MAMBA_SEQ, device=dev)
    mcluster = SplitInferenceCluster(
        model, mcfg, mprof,
        spec=ligd.SolverSpec(backend="chunked", per_user_split=True))
    ids = [mcluster.add_cell(x) for x in mscns]
    t0 = time.perf_counter()
    mcluster.start(threaded=False)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    tokens = torch.randint(0, mcfg.vocab_size,
                           (2, SERVE_USERS, MAMBA_SEQ), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED + 800)
                           ).numpy()
    by_cell = {c: tokens[i] for i, c in enumerate(ids)}
    ssd_scan.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches["ssd"] = ssd_scan.launches
    by_path["ssd"]["mamba2"] = launches["ssd"]
    if launches["ssd"] <= 0:
        raise AssertionError("ssd was not launched on the mamba2 path")
    check_served(out, ids, mcfg)
    groups = {int(c): {s_: len(u) for s_, u in
                       mcluster.installed_schedule(c).groups().items()}
              for c in ids}
    split, users = next(iter(mcluster.installed_schedule(ids[0])
                             .groups().items()))
    rows = torch.as_tensor(tokens[0][users[:4]], device=dev)
    fused, _ = transformer.forward(model, mcfg, rows, impl="kernel")
    split_errs = check_split(model, mcfg, rows, split, fused)
    # the same rows through the plain chunked scan, with no kernel
    # launched, and through the plain scan at chunk 128: two exact float32
    # orders of one scan, whose bf16 logits after 48 layers differ by the
    # model's own spread (each block's output rounds to bf16, and a one-ulp
    # flip grows with depth).  The kernel's logits may be no further from
    # the plain path's than twice that spread.
    n_ssd = ssd_scan.launches
    plain, _ = transformer.forward(model, mcfg, rows, impl="naive")
    plain128, _ = transformer.forward(model, mcfg.replace(ssd_chunk=128),
                                      rows, impl="naive")
    if ssd_scan.launches != n_ssd:
        raise AssertionError("the plain forward launched the ssd kernel")
    scaled = lambda got, want: float((got - want).abs().max()
                                     / want.abs().max())
    plain_err, spread = scaled(fused, plain), scaled(plain128, plain)
    if not plain_err <= MAMBA_SPREAD_FACTOR * spread:
        raise AssertionError(f"mamba2 kernel logits differ from the plain "
                             f"path's by {plain_err} of max |logit|, more "
                             f"than {MAMBA_SPREAD_FACTOR} x the plain "
                             f"path's own spread {spread}")
    # and each path against the plain path with its SSD in float64 (the
    # scan's y rounded to bf16 once): which of them is nearer the exact
    # scan
    def scan_f64(params, cfg, xs, dt, A, B, C, impl):
        y, state = ssd_ref.ssd_chunked(
            *(v.double() for v in (xs, dt, A, B, C, params.D)),
            chunk=min(cfg.ssd_chunk, xs.shape[1]))
        return y.to(xs.dtype), state.float()

    with mock.patch.object(ssm_mod, "_scan", scan_f64):
        plain64, _ = transformer.forward(model, mcfg, rows, impl="naive")
    f64_errs = {"kernel": scaled(fused, plain64),
                "plain": scaled(plain, plain64),
                "plain_chunk128": scaled(plain128, plain64)}
    del fused, plain, plain128, plain64
    # each block, kernel against plain, on the same input (the plain
    # stream): within PLAIN_LOGIT_TOL of the block output's max
    x = transformer.embed_tokens(model, mcfg, rows)
    block_err = 0.0
    for spec, layer in zip(mcfg.layer_specs, model.layers):
        y_k, _ = blocks.forward(layer, mcfg, spec, x, None, impl="kernel")
        x, _ = blocks.forward(layer, mcfg, spec, x, None, impl="naive")
        block_err = max(block_err, scaled(y_k, x))
    del x, y_k
    if not block_err <= PLAIN_LOGIT_TOL:
        raise AssertionError(f"a mamba2 block's kernel output differs from "
                             f"its plain output by {block_err} of max |y|, "
                             f"tolerance {PLAIN_LOGIT_TOL}")
    # the same model in float32, kernel against plain logits at full depth
    m32 = copy.deepcopy(model).float()
    f32_k, _ = transformer.forward(m32, mcfg, rows, impl="kernel")
    f32_p, _ = transformer.forward(m32, mcfg, rows, impl="naive")
    f32_err = scaled(f32_k, f32_p)
    if not f32_err <= PLAIN_LOGIT_TOL:
        raise AssertionError(f"float32 mamba2 kernel logits differ from the "
                             f"plain path's by {f32_err} of max |logit|, "
                             f"tolerance {PLAIN_LOGIT_TOL}")
    del m32, f32_k, f32_p
    t_prof, busy_s, top = profiled_round(mcluster, by_cell)
    mcluster.stop()
    log("mamba2_path", model=mcfg.name,
        params=transformer.param_count(model), d_model=mcfg.d_model,
        layers=mcfg.n_layers, vocab=mcfg.vocab_size, dtype=mcfg.dtype,
        cells=2, users=SERVE_USERS, seq=MAMBA_SEQ,
        decode_steps=DECODE_STEPS, init_s=f"{t_init:.3f}",
        start_s=f"{t_start:.3f}", serve_round_s=f"{t_serve:.3f}",
        tokens_per_s=f"{n_tokens / t_serve:.1f}", peak_GiB=f"{peak_gib:.2f}",
        split_groups=json.dumps(groups).replace(" ", ""),
        split_vs_fused=json.dumps(split_errs).replace(" ", ""),
        kernel_vs_plain=f"{plain_err:.3e}",
        plain_chunk128_vs_plain=f"{spread:.3e}",
        kernel_vs_plain_tol=f"{MAMBA_SPREAD_FACTOR}x_spread",
        block_kernel_vs_plain_max=f"{block_err:.3e}",
        vs_f64_ssd=json.dumps({k: float(f"{v:.3e}") for k, v in
                               f64_errs.items()}).replace(" ", ""),
        f32_kernel_vs_plain=f"{f32_err:.3e}",
        block_and_f32_tol=PLAIN_LOGIT_TOL,
        launches=json.dumps({"ssd": launches["ssd"]}).replace(" ", ""))
    log("mamba2_path_profile", round_s=f"{t_prof:.3f}",
        device_busy_s=f"{busy_s:.3f}",
        device_busy_share=f"{busy_s / t_prof:.3f}",
        top_kernels_ms=json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
             for e in top}),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    del model, mcluster

    # ---- 12. the mixtral path ----------------------------------------------
    # mixtral-8x22b at published width (d_model 6144, 48 heads over 8 kv
    # heads, head_dim 128, d_ff 16384, 8 experts top-2, capacity factor
    # 1.25, window 4096, vocab 32768, bf16), every expert held, depth cut to
    # MIXTRAL_LAYERS of 56: a layer is 2.5 B parameters (5.0 GB), so the
    # whole model does not fit one card.  Weights are random from SEED.
    # One edge-only group of 8 users prefills 36,864 tokens: its expert
    # capacity, 11,520, rounds up to 16,384, two chunks of C_CHUNK.
    t_phase = time.perf_counter()
    mcfg = configs.get_config("mixtral-8x22b").replace(
        n_layers=MIXTRAL_LAYERS)
    t0 = time.perf_counter()
    model = transformer.init(torch.Generator().manual_seed(SEED), mcfg, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    moe_ncfg = network.small_config(n_users=MOE_USERS, n_subchannels=8)
    mscns = [network.make_scenario(
        torch.Generator().manual_seed(SEED + 1000 + i), moe_ncfg, dev)
        for i in range(2)]
    mprof = profiles.transformer_profile(mcfg, seq=MOE_SEQ, device=dev)
    mcluster = SplitInferenceCluster(
        model, mcfg, mprof,
        spec=ligd.SolverSpec(backend="chunked", per_user_split=True))
    ids = [mcluster.add_cell(x) for x in mscns]
    t0 = time.perf_counter()
    mcluster.start(threaded=False)
    torch.cuda.synchronize()
    t_start = time.perf_counter() - t0
    tokens = torch.randint(0, mcfg.vocab_size, (2, MOE_USERS, MOE_SEQ),
                           dtype=torch.int32,
                           generator=torch.Generator().manual_seed(
                               SEED + 1100)).numpy()
    by_cell = {c: tokens[i] for i, c in enumerate(ids)}

    # every MoE call's slots, kept on the card (no sync in the round):
    # (tokens a group, capacity, kept slots, slots)
    moe_calls = []
    slots_fn = moe_mod.slots

    def counted_slots(cfg_, idx, cap):
        out = slots_fn(cfg_, idx, cap)
        moe_calls.append((idx.shape[1], cap, out[2].sum(), out[2].numel()))
        return out

    flash_attention_bshd.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(moe_mod, "slots", counted_slots):
        t0 = time.perf_counter()
        out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    by_path["flash_attention"]["mixtral"] = flash_attention_bshd.launches
    if flash_attention_bshd.launches <= 0:
        raise AssertionError("flash_attention was not launched on the "
                             "mixtral path")
    check_served(out, ids, mcfg, MOE_USERS)
    # prefill calls see a group's users x MOE_SEQ tokens, decode calls one
    # token a user
    kept = {"prefill": [0, 0], "decode": [0, 0]}
    for tl, cap, n_kept, n_slots in moe_calls:
        part = kept["prefill" if tl > MOE_USERS else "decode"]
        part[0] += int(n_kept)
        part[1] += n_slots
    dropped = {k: 1.0 - k_ / n_ for k, (k_, n_) in kept.items()}
    chunked_calls = sum(cap > moe_mod.C_CHUNK and cap % moe_mod.C_CHUNK == 0
                        for _, cap, _, _ in moe_calls)
    if not chunked_calls:
        raise AssertionError(f"the chunked expert loop never ran: "
                             f"capacities {sorted({c for _, c, _, _ in moe_calls})}")
    groups = {int(c): {s_: len(u) for s_, u in
                       mcluster.installed_schedule(c).groups().items()}
              for c in ids}
    split, users = next(iter(mcluster.installed_schedule(ids[0])
                             .groups().items()))
    rows = torch.as_tensor(tokens[0][users[:4]], device=dev)
    fused, _ = transformer.forward(model, mcfg, rows, impl="kernel")
    split_errs = check_split(model, mcfg, rows, split, fused)
    del fused

    # the kernel path against the plain path on MOE_PLAIN_ROWS rows.  Each
    # MoE call records its (expert, keep) per (token, slot).  A bf16 ulp of
    # difference after attention flips some router near-ties; a flipped
    # token takes other experts, and through attention (near uniform with
    # random weights) every later layer of every token sees it.  So the
    # whole model is held against the plain path's own spread under the
    # same one-ulp change: the plain path with its probabilities kept in
    # float32 through P·V (the kernel is within one bf16 ulp of exactly
    # that).  Each block is held on the same input, where nothing
    # cascades: routes within MOE_FLIP_MAX, agreeing tokens' outputs
    # within PLAIN_LOGIT_TOL.
    rows = rows[:MOE_PLAIN_ROWS]
    n_tok = rows.numel()

    def routed_forward(m, xs, impl):
        """``m(xs, impl)``'s first output and each MoE call's (T, k)
        experts and keep mask."""
        routes = []

        def record(c_, idx, cap):
            out_ = slots_fn(c_, idx, cap)
            routes.append((idx.reshape(n_tok, -1),
                           out_[2].reshape(n_tok, -1)))
            return out_

        with mock.patch.object(moe_mod, "slots", record):
            y_, _ = m(xs, impl)
        return y_, routes

    def agreement(ra, rb):
        """Per token: routes equal in every call; and the share of (call,
        token, slot) routes that differ."""
        flips = [(ia != ib) | (ka != kb) for (ia, ka), (ib, kb) in
                 zip(ra, rb)]
        agree = ~torch.stack([f.any(-1) for f in flips]).any(0)
        share = float(sum(f.sum() for f in flips)) / sum(
            f.numel() for f in flips)
        return agree, share

    def scaled(got, want, agree=None):
        """max |got - want| / max |want|, over the tokens ``agree`` keeps
        (default: all)."""
        g_, w_ = (x.reshape(n_tok, -1) for x in (got, want))
        d_ = (g_ - w_).abs() if agree is None else (g_[agree] - w_[agree]).abs()
        return float(d_.max() / w_.abs().max())

    def sdpa_f32_probs(q_, k_, v_, mask_, scale_):
        """The plain attention with its probabilities kept in float32
        through P·V, rounded once at the output."""
        sc = torch.einsum("bshd,bthd->bhst", q_, k_).float() * scale_
        sc = torch.where(mask_, sc, attention_mod.NEG_INF)
        pr = torch.softmax(sc, dim=-1)
        return torch.einsum("bhst,bthd->bshd", pr, v_.float()).to(q_.dtype)

    full = lambda xs, impl: transformer.forward(model, mcfg, xs, impl=impl)
    lg_k, r_k = routed_forward(full, rows, "kernel")
    n_fa = flash_attention_bshd.launches
    lg_p, r_p = routed_forward(full, rows, "naive")
    with mock.patch.object(attention_mod, "_sdpa", sdpa_f32_probs):
        lg_s, r_s = routed_forward(full, rows, "naive")
    if flash_attention_bshd.launches != n_fa:
        raise AssertionError("the plain forwards launched the flash kernel")
    agree_kp, flips_kp = agreement(r_k, r_p)
    agree_sp, flips_sp = agreement(r_s, r_p)
    model_err, spread = scaled(lg_k, lg_p), scaled(lg_s, lg_p)
    model_err_agree = scaled(lg_k, lg_p, agree_kp)
    spread_agree = scaled(lg_s, lg_p, agree_sp)
    kernel_vs_f32probs = scaled(lg_k, lg_s)
    logit_bar = max(MAMBA_SPREAD_FACTOR * spread, PLAIN_LOGIT_TOL)
    flip_bar = max(MAMBA_SPREAD_FACTOR * flips_sp, MOE_FLIP_MAX)
    del lg_k, lg_p, lg_s, r_k, r_p, r_s

    positions = positions_for(mcfg, rows.shape[0], rows.shape[1],
                              device=dev)
    x = transformer.embed_tokens(model, mcfg, rows)
    block_err, block_flips = 0.0, 0.0
    for (mixer, _), layer in zip(mcfg.layer_specs, model.layers):
        h = blocks._norm(mcfg, x, layer.norm1)
        res = {}
        for impl in ("kernel", "naive"):
            x1 = x + attention_mod.forward(layer.mixer, mcfg, h, positions,
                                           mixer=mixer, impl=impl)
            h2 = blocks._norm(mcfg, x1, layer.norm2)
            y2, r_ = routed_forward(
                lambda xs, _i: moe_mod.forward(layer.ffn, mcfg, xs), h2,
                impl)
            res[impl] = (x1 + y2, r_)
        agree, share = agreement(res["kernel"][1], res["naive"][1])
        block_flips = max(block_flips, share)
        block_err = max(block_err, scaled(res["kernel"][0], res["naive"][0],
                                          agree))
        x = res["naive"][0]
        del res, h, x1, h2, y2
    del x

    # the same model in float32, kernel against plain: one layer at a time
    # is converted in place and back (bf16 -> float32 -> bf16 is exact; the
    # router stays float32), so a float32 copy of all six layers (62 GB)
    # never exists
    cfg32 = mcfg.replace(dtype="float32")
    head32 = Params(final_norm=model.final_norm.float(),
                    lm_head=model.lm_head.float())

    def layered_f32(xs, impl):
        x_ = transformer.embed_tokens(model, mcfg, xs).float()
        for spec, layer in zip(mcfg.layer_specs, model.layers):
            dtypes = [w_.dtype for w_ in layer.parameters()]
            for w_ in layer.parameters():
                w_.data = w_.data.float()
            try:
                x_, _ = blocks.forward(layer, cfg32, spec, x_, positions,
                                       impl=impl)
            finally:
                for w_, dt in zip(layer.parameters(), dtypes):
                    w_.data = w_.data.to(dt)
        return transformer.lm_logits(head32, cfg32, x_), None

    f32_k, r32_k = routed_forward(layered_f32, rows, "kernel")
    f32_p, r32_p = routed_forward(layered_f32, rows, "naive")
    agree32, flips32 = agreement(r32_k, r32_p)
    f32_err, f32_err_all = scaled(f32_k, f32_p, agree32), scaled(f32_k, f32_p)
    del f32_k, f32_p, r32_k, r32_p, head32
    t_prof, busy_s, top = profiled_round(mcluster, by_cell)
    mcluster.stop()
    log("mixtral_path", model=mcfg.name,
        params=transformer.param_count(model), d_model=mcfg.d_model,
        layers=f"{mcfg.n_layers}_of_56", experts=mcfg.n_experts,
        top_k=mcfg.top_k, vocab=mcfg.vocab_size, dtype=mcfg.dtype, cells=2,
        users=MOE_USERS, seq=MOE_SEQ, window=mcfg.window,
        decode_steps=DECODE_STEPS, init_s=f"{t_init:.3f}",
        start_s=f"{t_start:.3f}", serve_round_s=f"{t_serve:.3f}",
        tokens_per_s=f"{2 * MOE_USERS * DECODE_STEPS / t_serve:.1f}",
        peak_GiB=f"{peak_gib:.2f}",
        dropped_share=json.dumps({k: round(v, 4) for k, v in
                                  dropped.items()}).replace(" ", ""),
        capacities=",".join(map(str, sorted({c for _, c, _, _ in
                                             moe_calls}))),
        chunked_calls=chunked_calls,
        split_groups=json.dumps(groups).replace(" ", ""),
        split_vs_fused=json.dumps(split_errs).replace(" ", ""),
        rows=MOE_PLAIN_ROWS, model_route_flips=f"{flips_kp:.3e}",
        plain_f32probs_route_flips=f"{flips_sp:.3e}",
        flip_bar=f"{flip_bar:.3e}", kernel_vs_plain=f"{model_err:.3e}",
        plain_f32probs_vs_plain=f"{spread:.3e}",
        logit_bar=f"{logit_bar:.3e}",
        kernel_vs_plain_agreeing=f"{model_err_agree:.3e}",
        plain_f32probs_vs_plain_agreeing=f"{spread_agree:.3e}",
        kernel_vs_plain_f32probs=f"{kernel_vs_f32probs:.3e}",
        block_route_flips_max=f"{block_flips:.3e}",
        block_kernel_vs_plain_agreeing=f"{block_err:.3e}",
        f32_route_flips=f"{flips32:.3e}",
        f32_kernel_vs_plain_agreeing=f"{f32_err:.3e}",
        f32_kernel_vs_plain_all=f"{f32_err_all:.3e}",
        block_flip_max=MOE_FLIP_MAX, block_and_f32_tol=PLAIN_LOGIT_TOL,
        launches=json.dumps({"flash_attention": by_path["flash_attention"]
                             ["mixtral"]}).replace(" ", ""))
    log("mixtral_path_profile", round_s=f"{t_prof:.3f}",
        device_busy_s=f"{busy_s:.3f}",
        device_busy_share=f"{busy_s / t_prof:.3f}",
        top_kernels_ms=json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
             for e in top}),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    failed = [what for what, ok in (
        (f"model route flips {flips_kp} > {flip_bar}", flips_kp <= flip_bar),
        (f"model logits {model_err} > {logit_bar}", model_err <= logit_bar),
        (f"block route flips {block_flips} > {MOE_FLIP_MAX}",
         block_flips <= MOE_FLIP_MAX),
        (f"block outputs {block_err} > {PLAIN_LOGIT_TOL}",
         block_err <= PLAIN_LOGIT_TOL),
        (f"float32 route flips {flips32} > {MOE_FLIP_MAX}",
         flips32 <= MOE_FLIP_MAX),
        (f"float32 logits {f32_err} > {PLAIN_LOGIT_TOL}",
         f32_err <= PLAIN_LOGIT_TOL)) if not ok]
    if failed:
        raise AssertionError("the mixtral kernel path disagrees with its "
                             "plain path: " + "; ".join(failed))
    del model, mcluster, moe_calls
    torch.cuda.empty_cache()

    # ---- 13. the load generator -------------------------------------------
    # ``run_load`` drives a solver-only cluster of 8 cells x 16 users on the
    # fake clock: a flash crowd with and without the governor (the same
    # arrivals), then a mobility trace with handovers by ``move_user`` and
    # by leave+rejoin.  A FileSink keeps the governed run's events.
    t_phase = time.perf_counter()
    era_step_fused.launches = 0
    noma_rate.launches = 0
    flash = dict(spike_start=10, spike_rounds=20)
    with tempfile.TemporaryDirectory() as tmp:
        bus = TelemetryBus(capacity=8192)
        sink = FileSink(os.path.join(tmp, "load.jsonl"))
        bus.attach(sink)
        gov = run_load(make_trace("flash", **flash), target_users=LOAD_USERS,
                       governor=QoSGovernor(), bus=bus, seed=SEED)
        bus.detach(sink)
        sink.close()
        with open(os.path.join(tmp, "load.jsonl")) as f:
            n_lines = sum(1 for _ in f)
    n_events = sum(bus.count(name) for name in bus.streams())
    off = run_load(make_trace("flash", **flash), target_users=LOAD_USERS,
                   seed=SEED)
    mobile = {mode: run_load(make_trace("mobility", **flash),
                             target_users=MOBILITY_USERS, seed=SEED,
                             handover_mode=mode)
              for mode in ("move", "rejoin")}
    torch.cuda.synchronize()
    by_path["era_step"]["loadgen"] = era_step_fused.launches
    by_path["noma_rate"]["loadgen"] = noma_rate.launches
    if (gov.n_users, gov.rounds) != (off.n_users, off.rounds):
        raise AssertionError(f"the governor A/B saw other arrivals: "
                             f"{gov.n_users}/{gov.rounds} against "
                             f"{off.n_users}/{off.rounds}")
    if not (gov.n_deferred + gov.n_forced > 0
            and gov.extra["spike_lanes_solved"]
            < off.extra["spike_lanes_solved"]):
        raise AssertionError(f"the governor shed nothing in the spike: "
                             f"{gov.as_record()}")
    if n_lines != n_events:
        raise AssertionError(f"the trace holds {n_lines} lines, the bus "
                             f"emitted {n_events} events")
    for name in ("era_step", "noma_rate"):
        if by_path[name]["loadgen"] <= 0:
            raise AssertionError(f"{name} was not launched by run_load")
    for mode, rep in mobile.items():
        if not rep.handovers > 0:
            raise AssertionError(f"no handover in mode {mode}")

    def load_fields(rep):
        return dict(users=rep.n_users, rounds=rep.rounds,
                    rounds_per_s=round(rep.rounds_per_s, 3),
                    users_per_s=round(rep.users_per_s, 1),
                    p50_solve_ms=round(rep.p50_solve_ms, 3),
                    p99_solve_ms=round(rep.p99_solve_ms, 3),
                    p99_swap_lag_ms=round(rep.p99_swap_lag_ms, 3),
                    attainment=round(rep.qoe_attainment, 4),
                    lanes_solved=rep.lanes_solved,
                    spike_lanes_solved=rep.extra.get("spike_lanes_solved"),
                    deferred=rep.n_deferred, prioritised=rep.n_prioritised,
                    forced=rep.n_forced, wall_s=round(rep.wall_s, 3))

    log("loadgen", cells=gov.n_cells, users_per_cell=gov.users_per_cell,
        trace="flash", governed=json.dumps(load_fields(gov)).replace(" ", ""),
        ungoverned=json.dumps(load_fields(off)).replace(" ", ""),
        trace_lines=n_lines, bus_events=n_events)
    log("loadgen_mobility", **{
        mode: json.dumps(dict(load_fields(rep), handovers=rep.handovers,
                              p99_handover_ms=round(rep.p99_handover_ms, 3))
                         ).replace(" ", "")
        for mode, rep in mobile.items()},
        launches=json.dumps({n: by_path[n]["loadgen"] for n in
                             ("era_step", "noma_rate")}).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")

    # ---- 14. the launcher ---------------------------------------------------
    # ``python -m repro_torch.launch.serve`` in process, on the card (no
    # --device): the async cluster with the governor, churn and a JSONL
    # trace on the tiny mixtral, then the one-cell mode on the tiny dbrx
    t_phase = time.perf_counter()
    for name in ("era_step", "noma_rate", "flash_attention"):
        KERNEL_FNS[name].launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "serve.jsonl")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_async = serve.main([
                "--arch", "mixtral-8x22b", "--tiny", "--cells", "2",
                "--async-admission", "--rounds", "6", "--governor",
                "--churn", "--trace", trace_path])
        async_out = buf.getvalue().splitlines()
        with open(trace_path) as f:
            streams = {json.loads(line)["event"] for line in f}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_one = serve.main(["--arch", "dbrx-132b", "--tiny"])
    one_out = buf.getvalue().splitlines()
    torch.cuda.synchronize()
    for name in ("era_step", "noma_rate", "flash_attention"):
        by_path[name]["launcher"] = KERNEL_FNS[name].launches
    missing = {"bootstrap", "admission_round", "serve_round", "cell_join",
               "cell_leave"} - streams
    if rc_async != 0 or rc_one != 0 or missing:
        raise AssertionError(f"the launcher exited {rc_async} and {rc_one}; "
                             f"streams missing from its trace: {missing}")
    if not (any(ln.startswith("async admission: ") for ln in async_out)
            and "telemetry summary:" in async_out
            and one_out and one_out[0].startswith("served ")):
        raise AssertionError("the launcher's summary lines are missing:\n"
                             + "\n".join(async_out + one_out))
    summary = async_out[async_out.index("telemetry summary:") + 1:]
    log("launcher", async_run=repr(next(ln for ln in async_out
                                        if ln.startswith("async admission"))),
        summary=repr("; ".join(" ".join(ln.split()) for ln in summary
                               if ln.startswith("  "))),
        one_cell=repr(one_out[0]),
        streams=",".join(sorted(streams)),
        launches=json.dumps({n: by_path[n]["launcher"] for n in
                             ("era_step", "noma_rate", "flash_attention")}
                            ).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")

    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = by_path[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "launches_by_path", "max_abs_err", "max_scaled_err", "ms",
             "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "mixtral_shape", "mixtral_ms", "mixtral_plain_ms",
             "mixtral_bound_ms", "mixtral_library_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order if f in k}
                                  for k in kernels]}))
    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
