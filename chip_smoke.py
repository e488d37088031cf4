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
                requests: the ssd kernel and the mixer's two kernels
                (``ssm_mixer``, one counter) must have been launched in
                ``serve_round``, every user served, device + edge logits
                equal to the fused forward; for a group's rows against a
                plain forward (``impl="naive"``: the plain chunked scan
                and mixer ops, no kernel launched),
                the bf16 logits within twice the spread between two plain
                forwards (chunk 256 and 128), each block's kernel output
                within 2e-2 of its plain output on the same input, and
                the float32 model's logits within 2e-2 of max |logit|;
                each bf16 path's distance from a plain forward whose SSD
                runs in float64 is logged; after the profiled round, a
                round with the spans on: every ``ssm`` span has
                ``mixer_launches`` 2 (the spans and the round's mixer
                launches logged)
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
                serve_round, cell_join and cell_leave), the one-cell mode
                on the tiny dbrx, and ``--backend sharded --cells 3`` on
                the tiny mixtral
 15. baselines  the paper's Figs. 12–13 on one paper-width cell (yolov2):
                ERA (``ligd.solve``, 400 steps) and every baseline of
                ``baselines.run_all`` at 0.6, 0.9 and 1.2 x ERA's mean
                latency at a loose (1 s) budget; per method Γ, mean delay
                and energy, users over their threshold, average
                exceedance and wall time; every Γ finite, Device-Only all
                at F, Edge-Only's feasible users at 0, Γ_ERA <= 1.15 x
                each baseline's; DNN-Surgery and IAO (at the cut budget)
                with the fused and the autograd step, held to each other
                with phase 5's bar
 16. sharded    B=3 paper-width cells (100 GD steps, stop tolerance 1e-3)
                with ``backend="sharded"`` over ``cells_mesh()`` (one
                shard on the card) and over (cuda:0, cuda:0), held to
                ``backend="chunked"``: equal
                splits and iteration counts, Γ within rtol 1e-5; each
                shard's era_step launches (less a capture's warm-up)
                equal its own lanes' GD iterations (each shard stops on
                its own); the sorted lane
                placement twice, its splits, iterations and allocations
                bitwise the 'none' placement's and Γ within rtol 1e-5
                (bitwise where a lane keeps its position in its shard)
 17. multihost  ``backend="multihost"`` in one process bitwise
                ``backend="sharded"``; then two processes in a gloo group,
                2 paper-width lanes each on cuda:0, each bitwise equal to
                its lanes of the single-process two-shard sharded solve of
                all 4; 0 collective bytes in each process's sweep; a
                fenced cluster lifecycle (add_cell, move_user,
                remove_cell, one round) across them at a small config,
                and a divergent fence tag raising in both.  The children
                load the library phase 2 built.
 18. training, tiny  the training path (``launch.steps``, ``training``,
                ``data.pipeline``) at the tiny float32 configs of
                internlm2, gemma, recurrentgemma, mamba2, mixtral, musicgen
                and qwen2-vl (64 tokens, batch 2, TF32 off as pinned): the
                gradients on the card against the CPU's (each leaf within
                1e-5 of its max |g|, the loss within rtol 1e-5), one train
                step on each (loss, total loss and gradient norm within
                rtol 1e-5, lr within 1e-6), and the card's new weights and
                moments against the CPU optimiser on the card's gradients
                (each leaf within 1e-6 of its max |value|); each model
                kernel called with an input that
                requires grad raises; a checkpoint save, restore and
                resume after 2 of 4 steps equals the uninterrupted run
                bitwise; the launcher trains the tiny internlm2 on the
                card (no ``--device``)
 19. training, full  internlm2-1.8b at full width and depth (bf16, 24
                layers, vocab 92544), train_4k's 4096 tokens at global
                batch 4, ``impl="chunked"``, remat on: a step at
                microbatches 2 against one at 1 from the same state (loss
                within rtol 2e-3, the largest weight difference printed),
                then ``training.loop.train`` for 12 steps: the median
                step and data ms of the last 8, tokens/s, model TFLOP/s
                (6·N·tokens a step; attention and the recompute left out)
                and its share of the bf16 peak, peak GiB, the first and
                last loss (every loss finite, the last below the first),
                each on a line of its own; one more step under the
                profiler: device-busy share, the GEMMs' share and the top
                kernels by device time.  Neither training phase may
                launch a kernel (the kernels refuse gradients): each
                kernel's count on both paths is 0
 20. mesh       the sharded train step (``distributed.sharding``,
                ``launch.mesh``) on a 2 x 2 ("data", "model") mesh of four
                child processes sharing cuda:0 in one gloo group, with
                ``launch.mesh.gloo_all_gather`` as the all-gather
                transport (named in the line): llama3-8b, dbrx-132b and
                mamba2-780m at their tiny float32 configs (d_model 256,
                d_ff 512), one sharded step against the unsharded one on
                the card at the JAX suite's bars (loss 1e-4, weights
                2e-4 after an lr-sized first step) and the gradients
                within 1e-5 of each leaf's max; then internlm2-1.8b at
                full width and depth: the first batch's sharded
                gradients against the parent's, and two sharded steps
                against the parent's two unsharded steps from the same
                weights and batches (loss within 1e-3 relative, each
                leaf's weights against its own update); a half-batch
                control, which must fail the gradient and update bars;
                each rank's step ms, peak GiB and collective bytes by
                type (the first step counted by ``launch.hlo_cost``) and
                the kernels' launches the children count (path
                ``mesh_train``: 0 each)
 21. dry run    ``launch.dryrun.run_pair`` on the production meshes under a
                fake process group of 256 / 512 ranks, on ``meta``:
                internlm2-1.8b train_4k and mixtral-8x22b decode_32k on
                16 x 16, mamba2-780m long_500k on 2 x 16 x 16; each pair's
                per-chip bytes against 80 GB, FLOPs, collective bytes and
                roofline row (``launch.roofline``), and the card's
                total_memory beside the data sheet's 80 GB (path
                ``dryrun``, 0 launches); first ``launch.hlo_cost``'s count
                of one sharded product under this torch's DTensor: one
                rank's 1/256 of the global FLOPs

 22. graphed sweep  the compiled sweep (``SolverSpec.compiled_sweep``,
                ``core/sweep_graph``; phases 5–17 already run it as the
                default): (a) phase 6's sweep (two paper-width cells,
                yolov2, chunked, 400 steps) graphed and eager on the same
                inputs: equal splits and iteration counts, Γ and every
                allocation leaf bitwise (else within rtol 1e-5, the largest
                difference printed), equal era_step launches (the first
                run's less its capture warm-ups'); ms per GD
                step both ways, replays, host reads of the done flag, and
                what this torch exposes of conditional-node capture;
                (b) the cells' channels drawn again through the cached
                runner (no capture), equal to their eager sweep, each
                lane's Γ landscape moved by more than the bar; (c) one
                cell, ``ligd.solve`` with ``compiled_sweep=False`` against
                the default; (d) the autograd and adaptive bodies at
                phase 5's config (20 steps), graphed against eager (the
                autograd eager loop also against itself), and the graph
                pool's reserved bytes; (e) phase 6's cluster on the
                default: bootstrap and an admission round (wall s, ms per
                step), a second round under the profiler (the card's busy
                share, era_step's device ms a step and the rest's, the top
                other kernels, pass0's records beside era_step's count);
                after (a), a graphed sweep of 16 steps a layer that
                captures, under the profiler: pass0's records must equal
                era_step's count, warm-up and replays included (a whole
                round's ~4e5 records can overflow the profiler's
                buffers); the graph pool is also logged after phases 6,
                12, 13, 14 and 17
 23. decode_attention  the decode-attention kernel at the decode shape of
                the benchmark's mixtral-8x22b.prefill4608 cell (global
                attention, as published: 8 users, a ring of 4617 slots at
                position 4608, H=48, K=8, D=128, bf16): within one bf16
                ulp of the plain version in float32 and no further off than the
                plain bf16 path; its device time (the kernel's ``ms``: 20
                calls captured as one CUDA graph, replayed between CUDA
                events; ``event_ms`` the CUDA-event time of a Python call,
                ``host_ms`` the wrapper's host time a call) beside its
                byte bound, the plain path's and
                ``scaled_dot_product_attention(enable_gqa=True)``'s (the
                library yardstick), its device time at other splits of
                the keys, and the registers and spills of every
                instantiation, none of which may spill.  Phases 9 and 12
                count its launches in their served decode and hold the
                first eager call of each shape there to the same two
                checks at the path's own shape: recurrentgemma-2b's
                D=256, 10 query heads on one KV head, window 2048, and
                phase 12's registry mixtral, whose 4096-key window has
                wrapped its ring of 4096 slots by position 4608
 24. granite kernels  after the kernels' JSON line: the three model
                kernels at the shapes of the benchmark's
                granite-4.0-h-small.prefill4096 cell (bf16), each
                within one bf16 ulp of its plain version in float32 (the
                plain versions run a few batch rows at a time):
                flash_attention with NoPE (nothing rotates q and k) at
                B=8, S=4096, H=32, K=8, D=128, global causal, scale
                1/128, q and k drawn x 128^¼ as the cell's weights give
                them, also within 2e-2 of the plain bf16 version;
                decode_attention at B=8, a ring of 4105 slots at
                position 4096, H=32, K=8, D=128, scale 1/128, no further
                off than the plain bf16 path; ssd at the Mamba-2 layers'
                128 heads (B=8, L=4096, H=128, P=64, N=128, chunk 256, A
                down to -128), each output also held with the float32
                plain version to the float64 one (the outputs over the
                bar counted); each kernel's CUDA-event time a call.  The
                ssd misses its bar at a few outputs (PERF.md §6, ROADMAP
                queue 1), so the run ends here, non-zero
 25. ssm mixer  before the kernels' JSON line (its entry ``ssm_mixer``:
                both kernels' device time together, at mamba2's shape
                and at granite's): the Mamba-2 mixer's two elementwise
                kernels (causal_conv_silu, gated_rms_norm) at the serve
                cells' shapes, mamba2-780m's (B=16, L=2048, 3328 conv
                channels, d_inner 3072) and granite-4.0-h-small's (B=8,
                L=4096, 8448, 8192), and at their decode step's (L=1,
                where the gate kernel runs), read in place from an
                in_proj output of the model's row stride: each within
                one bf16 ulp of its plain version in float32 and no
                further off than the plain bf16 path; each kernel's
                device time (20 calls replayed
                as one CUDA graph between events, as phase 23 times its
                kernel: the profiler records no kernel this late), its
                byte bound at 3.35 TB/s and the plain path's time;
                one whole ``ssm.prefill`` of a full-width layer with the
                kernels and with the plain ops (the ``ssm`` span's
                ``mixer_launches``); the registers and spills of every
                instantiation, none of which may spill

Then the kernels' JSON line (``max_abs_err`` is the largest absolute
difference over every output; ``max_scaled_err`` the largest of the
quantities the tolerances bound: Γ's relative error and each leaf's
error over its max abs; ``launches`` the count on each kernel's first
path, ``launches_by_path`` its count on every path that runs it; flash's
``mixtral_*`` keys its times at mixtral's shape, the mixer's
``granite_*`` its times at granite's), phase 24's line, the card's
``name, power.limit`` line from nvidia-smi, and as the last line
``{"ok": true, "device": {...}}``.  Nothing is caught: any failure exits
non-zero, and so does a machine without a card.
"""
import contextlib
import copy
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
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
# phases 16–17 and phase 15's fused-against-autograd IAO: the GD step
# budget at the paper's width, cut from SolverSpec's 400 to keep phases
# 15–17 near 90 s (PERF.md §4).  Phase 15's ERA keeps 400 and run_all's
# baselines their own budgets: ERA cut to 100 steps scores 2.6% worse
# than IAO at its 300
NEW_PATH_STEPS = 100
# phases 16–17: the GD stop tolerance.  At 1e-5 (SolverSpec's default)
# every paper-width lane runs every layer to the budget, so no shard
# could stop before another; at this tolerance lanes stop at their own
# steps
SHARD_TOL = 1e-3
# phase 15: the QoE thresholds of benchmarks/fig12_13_vs_baselines.py, as
# multiples of ERA's mean latency at a loose (1 s) budget
FIG12_MULTIPLES = (0.6, 0.9, 1.2)
# phase 22: where a graphed result is not bitwise the eager loop's, it is
# held at the solver's bar (ROADMAP.md): Γ relative, each allocation leaf
# against its max |value|
GRAPH_RTOL = 1e-5
# phase 22 (d)'s GD budget for the autograd and adaptive bodies
BODY_STEPS = 20
# phase 22's profiled count check: a budget of two replays a layer, so the
# window holds ~4e4 device records (a whole admission round's ~4.2e5 can
# overflow the profiler's buffers: the tail of the round goes missing)
COUNT_STEPS = 16
# era_step's five launches (colsum twice), by ``short_name``
ERA_KERNELS = ("pass0_kernel", "colsum_kernel", "tail_kernel",
               "pass1_kernel")
# phase 17: seconds a child process may take
CHILD_TIMEOUT_S = 300
# phase 18: the seven families trained at their tiny float32 configs, one
# step on the card against the same step on the CPU; 64 tokens are two
# chunks of the tiny mamba2's 32 and past the tiny window of 64 with the
# vision prefix
TRAIN_ARCHS = ("internlm2-1.8b", "gemma-2b", "recurrentgemma-2b",
               "mamba2-780m", "mixtral-8x22b", "musicgen-medium",
               "qwen2-vl-72b")
TINY_SEQ, TINY_BATCH = 64, 2
# the tolerances of the CPU suite (tests/test_torch_training.py): the
# loss, the gradient norm and the learning rate relative; each gradient
# leaf against its max |g|; the optimiser's outputs on equal inputs,
# each leaf against its max |value| (elementwise relative error blows
# up where a new weight cancels to ~0)
LOSS_RTOL, GRAD_TOL, OPT_RTOL = 1e-5, 1e-5, 1e-6
# phase 19: internlm2-1.8b at full width and depth, train_4k's sequence
# at global batch 4 (256 in JAX's shape, cut for one card), remat on
FULL_ARCH, FULL_SEQ, FULL_BATCH = "internlm2-1.8b", 4096, 4
FULL_STEPS, FULL_TIMED = 12, 8      # timed: the median of the last 8
# microbatches=2 against 1 from one state: the loss, relative
MICROBATCH_RTOL = 2e-3
# phase 20: four ranks on cuda:0 in one gloo group, a 2 x 2 ("data",
# "model") mesh.  (a) the three families of the JAX suite's sharded-step
# test at their tiny float32 configs, d_model 256, d_ff 512, 32 tokens at
# batch 8, held to its bars: the loss within 1e-4, every weight within
# 2e-4 (tests/test_distributed_equivalence.py), after one step at lr 3e-4
# with a warmup of one step, so the update (lr·sign(g) on the first Adam
# step) is larger than the bar; and every gradient leaf within 1e-5 of
# its max |g| (phase 18's bar), which the half batch's gradients must
# exceed (the control)
MESH_AXES = (2, 2)
MESH_ARCHS = ("llama3-8b", "dbrx-132b", "mamba2-780m")
MESH_LOSS_TOL, MESH_PARAM_TOL, MESH_GRAD_TOL = 1e-4, 2e-4, 1e-5
# (b) internlm2-1.8b at full width and depth, phase 19's 4 x 4096 tokens,
# two sharded steps against the parent's two unsharded steps from the
# same weights and batches: the loss within 1e-3 relative (phase 19's
# microbatch comparison of the same bf16 step summed in another order
# holds 2e-3); the first batch's gradients, each leaf's largest error
# against its max |g|; the weights after the two steps, each leaf's
# distance from the unsharded ones over the unsharded update of that leaf
# (||w - w_ref|| / ||w_ref - w0||; leaves that bf16 rounding keeps at
# their start, the norms' ones, must stay there).  Both bars sit between
# the sound run's readings and the least leaf of the half-batch control,
# which the parent runs: gradients 1.020e-2 against 0.2448, updates
# 7.854e-2 against 0.5729 (H100 80GB HBM3, 700 W; PERF.md §6)
MESH_FULL_STEPS = 2
MESH_FULL_LR = 1e-3
MESH_FULL_LOSS_RTOL = 1e-3
MESH_FULL_GRAD_TOL = 5e-2
MESH_FULL_UPDATE_TOL = 0.25
# phase 24: the benchmark's granite-4.0-h-small.prefill4096 cell's users
# of a cell and request length (16 chunks of its 256)
GRANITE_USERS, GRANITE_SEQ = 8, 4096
# phase 21: the dry run's pairs on the production meshes: (arch, shape,
# the 2 x 16 x 16 mesh)
DRYRUN_PAIRS = (("internlm2-1.8b", "train_4k", False),
                ("mixtral-8x22b", "decode_32k", False),
                ("mamba2-780m", "long_500k", True))


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


def graph_ms(fn, reps=20):
    """Device ms of a call of ``fn``: ``reps`` calls captured as one CUDA
    graph and replayed between CUDA events, so no host time falls between
    the launches (CUDA events around Python calls count the wrapper's
    host time once that is the longer).  Late in the script, where the
    profiler records no kernel after phase 22's long profiled session."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


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


def assert_same_solve(got, want, what, exact=False):
    """Equal splits and iteration counts, Γ within rtol 1e-5 (``exact``:
    every output bitwise equal)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outcomes, not {len(want)}")
    for b, (x, y) in enumerate(zip(got, want)):
        if not (np.array_equal(x.s, y.s)
                and np.array_equal(x.iters_by_layer, y.iters_by_layer)):
            raise AssertionError(f"{what}: lane {b}'s splits or iteration "
                                 f"counts differ")
        if exact:
            same = (np.array_equal(x.gamma_by_layer, y.gamma_by_layer)
                    and all(torch.equal(a, c)
                            for a, c in zip(x.alloc, y.alloc)))
            if not same:
                raise AssertionError(f"{what}: lane {b} is not bitwise "
                                     f"equal")
        else:
            np.testing.assert_allclose(x.gamma_by_layer, y.gamma_by_layer,
                                       rtol=1e-5, err_msg=f"{what} {b}")


def gamma_rel(got, want):
    return max(float(np.max(np.abs(x.gamma_by_layer - y.gamma_by_layer)
                            / np.abs(y.gamma_by_layer)))
               for x, y in zip(got, want))


def phase_baselines(dev, by_path):
    """Phase 15: the paper's Figs. 12–13 on the card (module docs)."""
    from repro_torch.core import baselines, ligd, network, profiles, qoe
    from repro_torch.kernels.era_step.kernel import era_step_fused
    t_phase = time.perf_counter()
    cfg, (scn,) = paper_cells(network, 1, dev)
    prof = profiles.get_profile("yolov2", device=dev)
    u, f = cfg.n_users, prof.n_layers
    spec = ligd.SolverSpec(backend="chunked")
    era_step_fused.launches = 0
    t0 = time.perf_counter()
    loose = ligd.solve(scn, prof, torch.full((u,), 1.0, device=dev),
                       spec=spec)
    nominal = float(loose.terms.t.mean())
    t_loose = time.perf_counter() - t0
    table = {}
    for mult in FIG12_MULTIPLES:
        q = torch.full((u,), nominal * mult, device=dev)
        runs = [("era", lambda: ligd.solve(scn, prof, q, spec=spec))]
        runs += [(name, lambda fn=fn: fn(scn, prof, q))
                 for name, fn in baselines.ALL_BASELINES.items()]
        rows = {}
        for name, fn in runs:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_over, sum_over = qoe.violations(out.terms.t, q)
            rows[name] = dict(
                gamma=float(out.terms.gamma), delay_s=float(out.terms.t.mean()),
                energy_j=float(out.terms.e.mean()),
                users_over=int(n_over), avg_exceed=float(sum_over) / u / nominal,
                wall_s=round(wall, 3), out=out)
        table[mult] = rows
        log("baselines", threshold=f"{mult}x{nominal:.6f}s", **{
            name: json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                              for k, v in r.items() if k != "out"}
                             ).replace(" ", "")
            for name, r in rows.items()})
    by_path["era_step"]["baselines"] = era_step_fused.launches
    for mult, rows in table.items():
        era_g = rows["era"]["gamma"]
        for name, r in rows.items():
            if not np.isfinite(r["gamma"]):
                raise AssertionError(f"{name} at {mult}x: Γ not finite")
            if name != "era" and not era_g <= 1.15 * r["gamma"]:
                raise AssertionError(f"Γ_ERA {era_g} > 1.15 x {name}'s "
                                     f"{r['gamma']} at {mult}x")
        if not (rows["device_only"]["out"].s == f).all():
            raise AssertionError("Device-Only has a split other than F")
        edge = rows["edge_only"]["out"].s
        if not (edge[edge != f] == 0).all():
            raise AssertionError("an Edge-Only feasible user is not at 0")
    # DNN-Surgery and IAO with the fused and the autograd step at the
    # middle threshold, held to each other with phase 5's bar; IAO at the
    # phase's budget (its autograd step takes ~0.14 s a step at this width)
    mult = FIG12_MULTIPLES[1]
    q = torch.full((u,), nominal * mult, device=dev)
    step_bar = {}
    for name, kw in (("dnn_surgery", {}),
                     ("iao", {"max_steps": NEW_PATH_STEPS})):
        fn = baselines.ALL_BASELINES[name]
        x = fn(scn, prof, q, **kw)
        t0 = time.perf_counter()
        y = fn(scn, prof, q, step_impl="autograd", **kw)
        torch.cuda.synchronize()
        autograd_s = time.perf_counter() - t0
        rel = abs(float(x.terms.gamma) - float(y.terms.gamma)) \
            / abs(float(y.terms.gamma))
        step_bar[name] = dict(splits_equal=bool(np.array_equal(x.s, y.s)),
                              iters=[x.iters, y.iters],
                              gamma_rel_err=float(f"{rel:.3e}"),
                              autograd_s=round(autograd_s, 3))
        if not (np.array_equal(x.s, y.s) and x.iters == y.iters
                and rel <= 1e-4):
            raise AssertionError(f"{name}: fused and autograd steps differ "
                                 f"beyond phase 5's bar: {step_bar[name]}")
    if by_path["era_step"]["baselines"] <= 0:
        raise AssertionError("era_step was not launched by the baselines")
    log("baselines_check", cell=f"U{u}xM{cfg.n_subchannels}xN{cfg.n_aps}",
        profile="yolov2", era_max_steps=spec.max_steps,
        step_kinds_max_steps=NEW_PATH_STEPS,
        nominal_delay_s=f"{nominal:.6f}", loose_era_s=f"{t_loose:.3f}",
        gamma_era_le_1_15x=True,
        fused_vs_autograd=json.dumps(step_bar).replace(" ", ""),
        launches=by_path["era_step"]["baselines"],
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def phase_sharded(dev, by_path):
    """Phase 16: the sharded backend on the card (module docs).  Returns
    the cells, profile, thresholds and the one-shard outcomes, which
    phase 17 holds the multihost backend to."""
    from repro_torch.core import ligd, network, profiles
    from repro_torch.distributed import solver_mesh
    from repro_torch.kernels.era_step.kernel import era_step_fused
    t_phase = time.perf_counter()
    cfg, scns = paper_cells(network, 3, dev)
    prof = profiles.get_profile("yolov2", device=dev)
    q = torch.full((3, cfg.n_users), 0.4, device=dev)
    base = ligd.SolverSpec(backend="chunked", per_user_split=False,
                           max_steps=NEW_PATH_STEPS, tol=SHARD_TOL)
    t0 = time.perf_counter()
    ref = ligd.solve_batch(scns, prof, q, spec=base)
    t_ref = time.perf_counter() - t0
    one = solver_mesh.cells_mesh()
    two = solver_mesh.cells_mesh(2, device=dev)
    sharded = base.replace(backend="sharded")
    era_step_fused.launches = 0
    t0 = time.perf_counter()
    sh1 = ligd.solve_batch(scns, prof, q, spec=sharded.replace(mesh=one))
    t_sh1 = time.perf_counter() - t0
    # each shard's launches, counted around its own sweep, less those of a
    # capture's warm-up (a shard's first sweep at its shape captures)
    shard_launches = []
    sweep = ligd._sweep_core

    def counted(*a, **kw):
        n0 = era_step_fused.launches
        w0 = ligd.SWEEP_STATS["warmup_launches"]
        out = sweep(*a, **kw)
        shard_launches.append(era_step_fused.launches - n0 - (
            ligd.SWEEP_STATS["warmup_launches"] - w0))
        return out

    t0 = time.perf_counter()
    with mock.patch.object(ligd, "_sweep_core", counted):
        sh2 = ligd.solve_batch(scns, prof, q, spec=sharded.replace(mesh=two))
    t_sh2 = time.perf_counter() - t0
    assert_same_solve(sh1, ref, "sharded, one shard, against chunked")
    assert_same_solve(sh2, ref, "sharded, two shards, against chunked")
    # a shard's GD loop runs until ITS slowest lane stops, rounded up to
    # the chunk: the launches its own lanes need (lanes 0-1 and 2-2pad)
    chunk = sharded.check_every
    iters = np.stack([o.iters_by_layer for o in sh2])
    need = [int(np.minimum(-(-iters[lanes].max(axis=0) // chunk) * chunk,
                           NEW_PATH_STEPS).sum())
            for lanes in ([0, 1], [2])]
    if shard_launches != need:
        raise AssertionError(f"shard launches {shard_launches}, their own "
                             f"lanes need {need}")
    lockstep = int(np.minimum(-(-iters.max(axis=0) // chunk) * chunk,
                              NEW_PATH_STEPS).sum())
    srt = sharded.replace(mesh=two, lane_placement="sorted")
    ligd.reset_lane_history()
    t0 = time.perf_counter()
    ligd.solve_batch(scns, prof, q, spec=srt)
    perm = ligd._lane_permutation(3, 2)
    sorted_out = ligd.solve_batch(scns, prof, q, spec=srt)
    t_sorted = time.perf_counter() - t0
    ligd.reset_lane_history()
    # splits, iterations and allocations bitwise; Γ bitwise for a lane at
    # the same position in its shard, else within rtol 1e-5: torch's CUDA
    # reductions vectorise a row of U=1250 floats only where it starts
    # 16-byte aligned (even positions), so a lane's Γ sums depend in their
    # last bits on its position
    assert_same_solve(sorted_out, sh2, "sorted placement against 'none'")
    inv = np.argsort(perm)
    moved, gamma_bitwise = [], []
    for b, (x, y) in enumerate(zip(sorted_out, sh2)):
        if not all(torch.equal(a, c) for a, c in zip(x.alloc, y.alloc)):
            raise AssertionError(f"sorted placement: lane {b}'s "
                                 f"allocation is not bitwise 'none''s")
        same_pos = int(inv[b]) % 2 == b % 2
        exact = bool(np.array_equal(x.gamma_by_layer, y.gamma_by_layer))
        if same_pos and not exact:
            raise AssertionError(f"sorted placement: lane {b} kept its "
                                 f"position but its Γ differs")
        moved.append(not same_pos)
        gamma_bitwise.append(exact)
    by_path["era_step"]["sharded"] = era_step_fused.launches
    if by_path["era_step"]["sharded"] <= 0:
        raise AssertionError("era_step was not launched by the sharded "
                             "backend")
    log("sharded", cells=3, shape=f"U{cfg.n_users}xM{cfg.n_subchannels}"
        f"xN{cfg.n_aps}", profile="yolov2", max_steps=NEW_PATH_STEPS,
        chunked_s=f"{t_ref:.3f}", one_shard_s=f"{t_sh1:.3f}",
        two_shard_s=f"{t_sh2:.3f}",
        tol=SHARD_TOL,
        gamma_rel_err=f"{max(gamma_rel(sh1, ref), gamma_rel(sh2, ref)):.3e}",
        splits_iters_equal=True, shard_launches=",".join(map(str,
                                                              shard_launches)),
        lockstep_launches=lockstep,
        sorted_perm=",".join(map(str, perm)), sorted_s=f"{t_sorted:.3f}",
        sorted_moved=",".join(map(str, moved)),
        sorted_gamma_bitwise=",".join(map(str, gamma_bitwise)),
        sorted_gamma_rel_err=f"{gamma_rel(sorted_out, sh2):.3e}",
        lane_iters=",".join(str(o.total_iters) for o in sh2),
        launches=by_path["era_step"]["sharded"],
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return scns, prof, q, base, sh1


# phase 17's child: 2 of 4 paper-width lanes on cuda:0 in a gloo group of
# two, then a fenced cluster lifecycle at a small config.  It loads the
# library phase 2 built and imports nothing of JAX.
MH_CHILD = r"""
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
from repro_torch.kernels import _build
if not _build.lib_path().exists():
    sys.exit("the kernel library is not built: the parent builds it")
from repro_torch.distributed import multihost
info = multihost.initialize_from_env()
assert info.n_processes == 2 and dist.get_backend() == "gloo", info
pid = info.process_id
from repro_torch.core import era, ligd, network, profiles
from repro_torch.kernels.era_step.kernel import era_step_fused
from repro_torch.kernels.noma_rate.kernel import noma_rate
from repro_torch.serving.cluster import SplitInferenceCluster
dev = torch.device("cuda", 0)
steps, chunk, seed = (int(os.environ[k]) for k in
                      ("MH_STEPS", "MH_GD_CHUNK", "MH_SEED"))
tol = float(os.environ["MH_TOL"])
cfg = network.NetworkConfig()
lo, hi = multihost.lane_slice(2)
scns = [network.make_scenario(torch.Generator().manual_seed(seed + g), cfg,
                              dev) for g in range(lo, hi)]
prof = profiles.get_profile("yolov2", device=dev)
q = torch.full((2, cfg.n_users), 0.4, device=dev)
spec = ligd.SolverSpec(backend="multihost", per_user_split=False,
                       max_steps=steps, gd_chunk=chunk, tol=tol)
t0 = time.perf_counter()
outs = ligd.solve_batch(scns, prof, q, spec=spec)
torch.cuda.synchronize()
solve_s = time.perf_counter() - t0
np.savez(os.path.join(os.environ["MH_DIR"], f"lanes_{pid}.npz"),
         gamma=np.stack([o.gamma_by_layer for o in outs]),
         iters=np.stack([o.iters_by_layer for o in outs]),
         s=np.stack([o.s for o in outs]),
         **{f: np.stack([getattr(o.alloc, f).cpu().numpy() for o in outs])
            for f in era.Allocation._fields})
prep = ligd.prepare_batch(scns, prof, True)
cost = multihost.sweep_collective_cost(
    spec.run_mesh(), prep.scn_b, q, era.uniform_alloc(prep.scn_b),
    prep.pred_b, spec.lr, spec.tol, 5, era.Weights(), prep.prof_b)
assert cost.total_coll_bytes == 0.0 and cost.coll_bytes == {}, cost
fence = multihost.collective_cost(lambda: multihost.churn_fence("audit"))
assert fence.total_coll_bytes > 0, fence
small = network.small_config(n_users=12, n_subchannels=6)
nin = profiles.get_profile("nin", device=dev)
scn = lambda g: network.make_scenario(torch.Generator().manual_seed(g),
                                      small, dev)
cl = SplitInferenceCluster(None, None, nin, spec=spec.replace(max_steps=40),
                           device=dev)
ids = [cl.add_cell(scn(g), q0=0.4) for g in range(lo, hi)]
cl.start(threaded=False)
assert cl.scheduler.host_local_rounds
cid = cl.add_cell(scn(100 + pid), q0=0.4)
mv = cl.move_user(ids[1], cid, user=2)
assert mv.cells == (cl.lane_of(cid),), mv
cl.remove_cell(ids[0])
cl.submit(cid, user=0, q_s=0.35)
rnd = cl.step()
assert rnd is not None and rnd.cells == (cl.lane_of(cid),), rnd
cl.stop()
assert not cl.errors and cl.n_cells == 2
try:
    multihost.churn_fence(f"remove_cell:{pid}")
except RuntimeError as e:
    assert "disagree" in str(e), e
else:
    sys.exit("divergent fence tags did not raise")
torch.cuda.synchronize()
print("MH_CHILD " + json.dumps(dict(
    pid=pid, solve_s=round(solve_s, 3), coll_bytes=cost.total_coll_bytes,
    fence_bytes=fence.total_coll_bytes, versions=cl.schedule_version,
    era_step=era_step_fused.launches, noma_rate=noma_rate.launches)))
dist.destroy_process_group()
"""


def run_children(code, n_procs, env_extra):
    """``n_procs`` Python processes running ``code`` in one gloo group
    (the REPRO_MH_* variables), on a port bound from port 0 (retried once
    if it is taken meanwhile); their stdout.  A child that fails or
    overruns fails the phase, and every child is killed then."""
    for attempt in range(2):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        procs = []
        try:
            for pid in range(n_procs):
                env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                           REPRO_MH_COORDINATOR=f"localhost:{port}",
                           REPRO_MH_NUM_PROCESSES=str(n_procs),
                           REPRO_MH_PROCESS_ID=str(pid), **env_extra)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=ROOT, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
            outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt == 0 and any("address already in use" in err.lower()
                                for _, err in outs):
            continue
        for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"child {pid} exited {p.returncode}:\n"
                                     f"{out[-2000:]}\n{err[-4000:]}")
        return [out for out, _ in outs]


def phase_multihost(dev, by_path, sharded):
    """Phase 17: the multihost backend on the card (module docs)."""
    from repro_torch.core import era, ligd, network
    from repro_torch.distributed import multihost, solver_mesh
    from repro_torch.kernels.era_step.kernel import era_step_fused
    from repro_torch.kernels.noma_rate.kernel import noma_rate
    t_phase = time.perf_counter()
    scns, prof, q, base, sh1 = sharded
    era_step_fused.launches = 0
    noma_rate.launches = 0
    mh_spec = base.replace(backend="multihost")
    if mh_spec.run_mesh() is not solver_mesh.cells_mesh():
        raise AssertionError("the multihost mesh is not the sharded one")
    t0 = time.perf_counter()
    mh = ligd.solve_batch(scns, prof, q, spec=mh_spec)
    t_mh = time.perf_counter() - t0
    assert_same_solve(mh, sh1, "multihost against sharded, one process",
                      exact=True)
    parent = {"era_step": era_step_fused.launches,
              "noma_rate": noma_rate.launches}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = run_children(MH_CHILD, 2, {
            "MH_DIR": tmp, "MH_STEPS": str(NEW_PATH_STEPS),
            "MH_GD_CHUNK": str(base.gd_chunk), "MH_SEED": str(SEED),
            "MH_TOL": repr(base.tol)})
        t_children = time.perf_counter() - t0
        reports = [json.loads(next(ln for ln in out.splitlines()
                                   if ln.startswith("MH_CHILD "))[9:])
                   for out in outs]
        lanes = [dict(np.load(os.path.join(tmp, f"lanes_{pid}.npz")))
                 for pid in range(2)]
    for name in ("era_step", "noma_rate"):
        by_path[name]["multihost"] = parent[name] + sum(r[name]
                                                        for r in reports)
    # the single-process two-shard sharded solve of all 4 lanes: shards of
    # 2 lanes, the shape of each child's one shard
    cfg, cells = paper_cells(network, 4, dev)
    q4 = torch.full((4, cfg.n_users), 0.4, device=dev)
    ref = ligd.solve_batch(cells, prof, q4, spec=base.replace(
        backend="sharded", mesh=solver_mesh.cells_mesh(2, device=dev)))
    want = dict(gamma=np.stack([o.gamma_by_layer for o in ref]),
                iters=np.stack([o.iters_by_layer for o in ref]),
                s=np.stack([o.s for o in ref]),
                **{f: np.stack([getattr(o.alloc, f).cpu().numpy()
                                for o in ref])
                   for f in era.Allocation._fields})
    for pid, got in enumerate(lanes):
        for k, v in want.items():
            if not np.array_equal(v[2 * pid:2 * pid + 2], got[k]):
                raise AssertionError(f"process {pid}'s lanes differ from "
                                     f"the sharded solve in {k}")
    for r in reports:
        if r["coll_bytes"] != 0.0 or r["era_step"] <= 0:
            raise AssertionError(f"child report {r}")
    if by_path["era_step"]["multihost"] <= 0:
        raise AssertionError("era_step was not launched by the multihost "
                             "backend")
    log("multihost", one_process_s=f"{t_mh:.3f}", bitwise_sharded=True,
        processes=2, lanes_per_process=2, children_s=f"{t_children:.1f}",
        children=json.dumps(reports).replace(" ", ""),
        bitwise_two_shard_sharded=True, group_timeout_s=multihost.PG_TIMEOUT_S,
        launches=json.dumps({n: by_path[n]["multihost"] for n in
                             ("era_step", "noma_rate")}).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def _state_to(state, dev):
    """A copy of a train state on ``dev``."""
    from repro_torch.training import optim
    opt = state["opt"]
    cp = lambda d: {k: x.to(dev, copy=True) for k, x in d.items()}
    return {"params": copy.deepcopy(state["params"]).to(dev),
            "opt": optim.OptState(opt.step.to(dev, copy=True), cp(opt.m),
                                  cp(opt.v))}


def _train_leaves(state):
    from repro_torch.training import checkpoint
    return [x for _, x in checkpoint.leaves(state)]


def phase_training_tiny(dev, by_path, kernel_fns):
    """Phase 18: the training path at the tiny configs, on the card
    against the CPU (module docs)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_launcher
    from repro_torch.training import optim
    from repro_torch.training.loop import train
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    for fn in kernel_fns.values():
        fn.launches = 0
    worst = {}
    for arch in TRAIN_ARCHS:
        cfg = configs.get_tiny_config(arch).replace(dtype="float32")
        opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        state = steps.init_train_state(
            cfg, torch.Generator().manual_seed(SEED), cpu)
        batch = pipeline.for_config(cfg, TINY_SEQ, TINY_BATCH, seed=SEED,
                                    device=cpu).batch(0, 0)
        dbatch = {k: x.to(dev) for k, x in batch.items()}
        # the gradients: the card's against the CPU's
        grad_fn = steps.make_grad_fn(cfg, microbatches=1)
        t_c, l_c, g_c = grad_fn(state["params"], batch)
        dstate = _state_to(state, dev)
        t_d, l_d, g_d = grad_fn(dstate["params"], dbatch)
        g_d = {k: x.cpu() for k, x in g_d.items()}
        loss_err = max(abs(float(a) / float(b) - 1.0)
                       for a, b in ((l_d, l_c), (t_d, t_c)))
        grad_err = max(scaled_err(g_d[k], g_c[k]) for k in g_c)
        # one train step on each device from the same state; then the
        # CPU optimiser on the card's gradients: the card's new state
        ref = _state_to(state, cpu)
        _, ref["opt"], _ = optim.apply(
            opt_cfg, dict(ref["params"].named_parameters()), g_d, ref["opt"])
        step = steps.make_train_step(cfg, opt_cfg, microbatches=1)
        state, m_c = step(state, batch)
        dstate, m_d = step(dstate, dbatch)
        torch.cuda.synchronize()
        metric_err = max(abs(float(m_d[k]) / float(m_c[k]) - 1.0)
                         for k in ("loss", "total_loss", "grad_norm"))
        lr_err = abs(float(m_d["lr"]) / float(m_c["lr"]) - 1.0)
        # each leaf against its max |value|, as the gradients: new
        # weights that cancel to near 0 (|w| ~ lr) make an element's own
        # relative error a measure of the cancellation
        opt_err = max(scaled_err(got.detach().cpu(), want.detach())
                      for got, want in zip(_train_leaves(dstate),
                                           _train_leaves(ref)))
        worst[arch] = dict(loss=loss_err, grads=grad_err, step=metric_err,
                           lr=lr_err, opt=opt_err)
        if not (loss_err <= LOSS_RTOL and grad_err <= GRAD_TOL
                and metric_err <= LOSS_RTOL and lr_err <= OPT_RTOL
                and opt_err <= OPT_RTOL):
            raise AssertionError(f"{arch}: the card's train step differs "
                                 f"from the CPU's: {worst[arch]}")
    # the kernels refuse inputs that require grad, on the card
    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev)
    q, k, v = rn(1, 16, 2, 64), rn(1, 16, 1, 64), rn(1, 16, 1, 64)
    a, b = torch.rand(1, 16, 8, generator=g, device=dev), rn(1, 16, 8)
    x, dt = rn(1, 32, 2, 32), torch.rand(1, 32, 2, generator=g, device=dev)
    bc, ad = rn(1, 32, 32), -torch.rand(2, generator=g, device=dev)
    refused = []
    for name, call, t in (
            ("flash_attention", lambda: kernel_fns["flash_attention"](
                q, k, v), q),
            ("rglru_scan", lambda: kernel_fns["rglru_scan"](a, b), a),
            ("ssd", lambda: kernel_fns["ssd"](x, dt, ad, bc, bc, ad,
                                              chunk=32), x)):
        t.requires_grad_(True)
        try:
            call()
        except RuntimeError as e:
            if "impl=" not in str(e):
                raise
            refused.append(name)
        finally:
            t.requires_grad_(False)
    if len(refused) != 3:
        raise AssertionError(f"only {refused} refused inputs that require "
                             f"grad")
    # checkpoint resume on the card replays the uninterrupted run bitwise
    cfg = configs.get_tiny_config(FULL_ARCH).replace(dtype="float32")
    kw = dict(seq_len=TINY_SEQ, global_batch=4, log_every=1, device=dev,
              opt_cfg=optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=4))
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        whole, hist = train(cfg, steps=4, **kw)
        train(cfg, steps=2, ckpt_dir=tmp, **kw)
        resumed, hist_r = train(cfg, steps=4, ckpt_dir=tmp, resume=True,
                                **kw)
        rc = train_launcher.main(["--arch", FULL_ARCH, "--tiny", "--steps",
                                  "3"])
    bitwise = (all(torch.equal(p_, q_) for p_, q_ in
                   zip(_train_leaves(whole), _train_leaves(resumed)))
               and [h["loss"] for h in hist_r]
               == [h["loss"] for h in hist[2:]])
    if not bitwise or rc != 0:
        raise AssertionError(f"resume is not bitwise ({bitwise}) or the "
                             f"launcher exited {rc}")
    torch.cuda.synchronize()
    for name, fn in kernel_fns.items():
        by_path[name]["train_tiny"] = fn.launches
    if any(fn.launches for fn in kernel_fns.values()):
        raise AssertionError("a kernel was launched on the training path")
    log("train_tiny", archs=len(TRAIN_ARCHS), seq=TINY_SEQ,
        batch=TINY_BATCH, dtype="float32",
        worst=json.dumps({a: {k: float(f"{v:.3e}") for k, v in e.items()}
                          for a, e in worst.items()}).replace(" ", ""),
        tolerances=f"loss/step {LOSS_RTOL}, grads {GRAD_TOL}, optimiser "
                   f"{OPT_RTOL}", refused=",".join(refused),
        resume_bitwise=bitwise, launcher_rc=rc,
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def phase_training_full(dev, by_path, kernel_fns, smi):
    """Phase 19: internlm2-1.8b at full width and depth (module docs)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.training import optim
    from repro_torch.training.loop import train
    t_phase = time.perf_counter()
    cfg = configs.get_config(FULL_ARCH)
    torch.cuda.empty_cache()       # the earlier phases' cached blocks
    # what the earlier phases leave: tensors still held, and threads that
    # share the host with the (host-bound) sampler
    held_gib = torch.cuda.memory_allocated() / 2**30
    n_threads = threading.active_count()
    for fn in kernel_fns.values():
        fn.launches = 0
    # microbatches 2 against 1 from one state (the initial one: its
    # moments are zero, so the weights are all the state there is)
    # the loop's own optimiser settings for this many steps
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=max(FULL_STEPS // 10,
                                                          1),
                                total_steps=FULL_STEPS)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                                   dev)
    n_params = transformer.param_count(state["params"])
    batch = pipeline.for_config(cfg, FULL_SEQ, FULL_BATCH, seed=SEED,
                                device=dev).batch(0, 0)
    params = list(state["params"].parameters())
    # the initial weights and the nm=1 step's, on the host: the card
    # holds the state, an f32 accumulation buffer and the logits
    w0 = [p.detach().to("cpu", copy=True) for p in params]
    out = {}
    for nm in (1, 2):
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
            for d in (state["opt"].m, state["opt"].v):
                for x in d.values():
                    x.zero_()
            state["opt"].step.zero_()
        state, m = steps.make_train_step(cfg, opt_cfg, microbatches=nm)(
            state, batch)
        out[nm] = float(m["loss"])
        if nm == 1:
            w1 = [p.detach().to("cpu", copy=True) for p in params]
    mb_rel = abs(out[2] / out[1] - 1.0)
    mb_param_diff = max(float((p.detach().cpu().float() - w.float()).abs()
                              .max()) for p, w in zip(params, w1))
    del state, batch, params, w0, w1, m
    torch.cuda.empty_cache()
    if not mb_rel <= MICROBATCH_RTOL:
        raise AssertionError(f"microbatches=2 loss {out[2]} against "
                             f"{out[1]} at 1")
    # the timed run: the training loop, a fresh state from the seed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        state, hist = train(cfg, steps=FULL_STEPS, seq_len=FULL_SEQ,
                            global_batch=FULL_BATCH, opt_cfg=opt_cfg,
                            impl="chunked", log_every=1, seed=SEED,
                            device=dev)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # where a step's device time goes: one more step, profiled
    batch = pipeline.for_config(cfg, FULL_SEQ, FULL_BATCH, seed=SEED,
                                device=dev).batch(0, FULL_STEPS)
    step = steps.make_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    # kernel rows only: an operator's row repeats its kernels' time
    events = [e for e in trace.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in events) / 1e6
    gemm_s = sum(e.self_device_time_total for e in events
                 if re.search(r"gemm|xmma|cutlass|nvjet", e.key)) / 1e6
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    del state, batch, trace, events
    torch.cuda.empty_cache()
    for name, fn in kernel_fns.items():
        by_path[name]["train_full"] = fn.launches
    if any(fn.launches for fn in kernel_fns.values()):
        raise AssertionError("a kernel was launched on the training path")
    losses = [h["loss"] for h in hist]
    if not (len(losses) == FULL_STEPS and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"the full-width losses: {losses}")
    timed = hist[-FULL_TIMED:]
    step_ms = float(np.median([h["step_ms"] for h in timed]))
    data_ms = float(np.median([h["data_ms"] for h in timed]))
    tokens = FULL_SEQ * FULL_BATCH
    tflops = 6.0 * n_params * tokens / (step_ms / 1e3) / 1e12
    log("train_full", model=cfg.name, params=n_params, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=FULL_SEQ,
        batch=FULL_BATCH, impl="chunked", remat=True, steps=FULL_STEPS)
    log("train_full", step_ms_median_last8=f"{step_ms:.1f}",
        step_ms_each=json.dumps([round(h["step_ms"], 1) for h in hist]
                                ).replace(" ", ""))
    log("train_full", data_ms_per_batch=f"{data_ms:.1f}",
        data_share_of_step=f"{data_ms / (data_ms + step_ms):.3f}")
    log("train_full", tokens_per_s=f"{tokens / (step_ms / 1e3):.1f}")
    log("train_full", model_tflops=f"{tflops:.1f}",
        share_of_bf16_peak=f"{tflops * 1e12 / BF16_FLOPS_S:.4f}",
        counted="6*N*tokens, N the port's parameters, attention FLOPs "
                "and the remat recompute left out")
    log("train_full", peak_GiB=f"{peak_gib:.2f}",
        held_before_phase_GiB=f"{held_gib:.2f}")
    log("train_full", loss_first=f"{losses[0]:.4f}",
        loss_last=f"{losses[-1]:.4f}")
    log("train_full_profile", step_s=f"{prof_s:.3f}",
        device_busy_s=f"{busy_s:.3f}",
        device_busy_share=f"{busy_s / prof_s:.3f}",
        gemm_s=f"{gemm_s:.3f}", gemm_share_of_busy=f"{gemm_s / busy_s:.3f}",
        top_kernels_ms=json.dumps(
            {e.key[:60]: round(e.self_device_time_total / 1e3, 3)
             for e in top}))
    log("train_full", microbatch2_loss_rel=f"{mb_rel:.3e}",
        microbatch2_max_param_diff=f"{mb_param_diff:.3e}",
        tol=MICROBATCH_RTOL)
    log("train_full", nvidia_smi=repr(smi), host_threads=n_threads,
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


# phase 20's child: one rank of four on cuda:0, a 2 x 2 mesh over gloo
# with the one-card mesh's all-gather transport.  It imports nothing of
# JAX; its report carries the five kernels' launches on the sharded steps
# (training runs the plain paths: every count must stay 0).
MESH_CHILD = r"""
import json, os, sys, time
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.data import pipeline
from repro_torch.distributed import multihost
from repro_torch.distributed.sharding import ShardingRules, full_tensor
from repro_torch.kernels.era_step.kernel import era_step_fused
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.noma_rate.kernel import noma_rate
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.kernels.ssm_mixer import kernel as ssm_mixer
from repro_torch.launch import hlo_cost, mesh as mesh_mod, steps
from repro_torch.training import optim
KERNELS = {"era_step": era_step_fused, "noma_rate": noma_rate,
           "flash_attention": flash_attention_bshd,
           "rglru_scan": rglru_scan, "ssd": ssd_scan,
           "ssm_mixer": ssm_mixer}
rank = multihost.initialize_from_env().process_id
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
data_ax, model_ax = (int(v) for v in os.environ["MESH_AXES"].split(","))
mesh = mesh_mod.make_host_mesh(data_ax, model_ax, device_type="cuda")
assert mesh_mod.ranks_share_a_card(data_ax * model_ax)
seed = int(os.environ["MESH_SEED"])
launches = dict.fromkeys(KERNELS, 0)


def stage(name):
    print(f"MESH_STAGE rank={rank} {name}", flush=True)


def zero_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def add_counts():
    for name, fn in KERNELS.items():
        launches[name] += fn.launches


def grad_errs(grads, want):
    # each leaf's largest error against its largest |g|; the DTensors are
    # gathered on every rank (a collective), compared where want is given
    errs = {}
    for k, g in grads.items():
        g = full_tensor(g).float()
        if want is not None:
            w = want[k].to(g.device).float()
            errs[k] = float((g - w).abs().max()
                            / w.abs().max().clamp_min(1e-30))
    return errs


def half(batch):
    return {k: x[:x.shape[0] // 2] for k, x in batch.items()}


report = {"rank": rank, "tiny": {}}
with mesh_mod.gloo_all_gather():
    for arch in os.environ["MESH_ARCHS"].split(","):
        stage(f"tiny {arch}")
        cfg = get_tiny_config(arch).replace(dtype="float32", d_model=256,
                                            d_ff=512)
        batch = pipeline.for_config(cfg, 32, 8, device=dev).batch(0, 0)
        new = lambda: steps.init_train_state(
            cfg, torch.Generator().manual_seed(0), dev)
        # one warmup step: the first update moves each weight by lr
        opt_cfg = optim.AdamWConfig(warmup_steps=1)
        ref = new()
        _, _, g_ref = steps.make_grad_fn(cfg)(ref["params"], batch)
        ref, ref_m = steps.make_train_step(cfg, opt_cfg)(ref, batch)
        rules = ShardingRules(cfg, mesh, mode="train")
        place = lambda b: {k: rules.place(x, rules.batch_spec(x.shape))
                           for k, x in b.items()}
        state = rules.distribute_state(new())
        grad_fn = steps.make_grad_fn(cfg, constrain=rules.constrain)
        step = steps.make_train_step(cfg, opt_cfg, constrain=rules.constrain)
        zero_counts()
        with implicit_replication():
            _, _, g_sh = grad_fn(state["params"], place(batch))
            _, _, g_half = grad_fn(state["params"], place(half(batch)))
            got, m = step(state, place(batch))
        add_counts()
        grad = grad_errs(g_sh, g_ref)
        control = grad_errs(g_half, g_ref)
        loss = float(full_tensor(m["loss"]))
        diff = max(float((full_tensor(b.detach()) - a.detach()).abs().max())
                   for a, b in zip(ref["params"].parameters(),
                                   got["params"].parameters()))
        report["tiny"][arch] = {
            "loss_err": abs(loss - float(ref_m["loss"])),
            "param_err": diff, "grad_err": max(grad.values()),
            "half_batch_grad_err": max(control.values()),
            "half_batch_grad_err_min": min(control.values())}
        del ref, got, g_ref, g_sh, g_half
    # four ranks share the card: hand the tiny runs' cached blocks back
    torch.cuda.empty_cache()
    stage("full")
    cfg = get_config(os.environ["MESH_FULL_ARCH"])
    n_steps = int(os.environ["MESH_FULL_STEPS"])
    opt_cfg = optim.AdamWConfig(lr=float(os.environ["MESH_FULL_LR"]),
                                warmup_steps=1, total_steps=n_steps)
    rules = ShardingRules(cfg, mesh, mode="train")
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                   dev, rules=rules)
    batches = torch.load(os.environ["MESH_BATCHES"])
    place = lambda b: {k: rules.place(x.to(dev), rules.batch_spec(x.shape))
                       for k, x in b.items()}
    step = steps.make_train_step(cfg, opt_cfg, constrain=rules.constrain)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    # the first batch's gradients, against the parent's unsharded ones
    with implicit_replication():
        _, _, g_sh = steps.make_grad_fn(cfg, constrain=rules.constrain)(
            state["params"], place(batches[0]))
    g_ref = (torch.load(os.environ["MESH_REF_GRADS"], mmap=True)
             if rank == 0 else None)
    grad = grad_errs(g_sh, g_ref)
    del g_sh, g_ref
    stage("full gradients")
    losses, step_ms, coll = [], [], None
    for i in range(n_steps):
        batch = place(batches[i])
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with implicit_replication():
            if i == 0:
                with hlo_cost.CostMode() as mode:
                    state, m = step(state, batch)
                coll = mode.cost.coll_bytes
            else:
                state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(full_tensor(m["loss"])))
        stage(f"full step {i}")
    add_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    # each leaf's distance from the parent's weights after the same steps,
    # over the parent's own update of that leaf (leaves bf16 rounding kept
    # at their start are counted apart)
    if rank == 0:
        ref = torch.load(os.environ["MESH_REF"], mmap=True)
        moved = torch.load(os.environ["MESH_REF_UPDATES"])
    ratio, unmoved = {}, 0
    for name, p in state["params"].named_parameters():
        w = full_tensor(p.detach())
        if rank == 0:
            d = float((w.float() - ref[name].to(dev).float()).norm())
            if moved[name] > 0:
                ratio[name] = d / moved[name]
            elif d > 0:
                ratio[name] = float("inf")
            else:
                unmoved += 1
    report.update(full_losses=losses, full_step_ms=step_ms,
                  full_peak_GiB=peak, full_reserved_GiB=reserved,
                  full_coll_bytes_first_step=coll, launches=launches)
    if rank == 0:
        worst_g = max(grad, key=grad.get)
        worst_u = max(ratio, key=ratio.get)
        report.update(full_grad_err=grad[worst_g], full_grad_leaf=worst_g,
                      full_update_err=ratio[worst_u],
                      full_update_leaf=worst_u, full_unmoved_leaves=unmoved)
print("MESH_CHILD " + json.dumps(report), flush=True)
dist.destroy_process_group()
"""


def _leaf_err(got, want):
    """A gradient leaf's largest error against its largest |value|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def phase_mesh(dev, by_path, kernel_fns):
    """Phase 20: the sharded train step on a 2 x 2 mesh of four ranks
    sharing the card (module docs)."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.training import optim
    t_phase = time.perf_counter()
    for fn in kernel_fns.values():
        fn.launches = 0
    # the unsharded reference: the first batch's gradients, the full and
    # the half batch's; two full-width steps; two steps of half batches
    # from the same weights (the control); then freed
    cfg = configs.get_config(FULL_ARCH)
    opt_cfg = optim.AdamWConfig(lr=MESH_FULL_LR, warmup_steps=1,
                                total_steps=MESH_FULL_STEPS)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(SEED),
                                   dev)
    params = dict(state["params"].named_parameters())
    w0 = {n: p.detach().clone() for n, p in params.items()}
    data = pipeline.for_config(cfg, FULL_SEQ, FULL_BATCH, seed=SEED,
                               device=dev)
    batches = [data.batch(0, i) for i in range(MESH_FULL_STEPS)]
    half = lambda b: {k: x[:x.shape[0] // 2] for k, x in b.items()}
    grad_fn = steps.make_grad_fn(cfg)
    _, _, g_ref = grad_fn(state["params"], batches[0])
    g_ref = {k: g.cpu() for k, g in g_ref.items()}
    _, _, g_half = grad_fn(state["params"], half(batches[0]))
    half_grad = {k: _leaf_err(g, g_ref[k].to(dev)) for k, g in g_half.items()}
    del g_half

    def run(feed):
        state["opt"].step.zero_()
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(w0[n])
            for d in (state["opt"].m, state["opt"].v):
                for x in d.values():
                    x.zero_()
        step = steps.make_train_step(cfg, opt_cfg)
        losses, ms = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(state, feed(batch))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        return losses, ms

    ref_losses, ref_ms = run(lambda b: b)
    w_ref = {n: p.detach().clone() for n, p in params.items()}
    moved = {n: float((w_ref[n].float() - w0[n].float()).norm())
             for n in params}
    run(half)
    half_update = {n: float((p.detach().float() - w_ref[n].float()).norm())
                   / moved[n] for n, p in params.items() if moved[n] > 0}
    parent_launches = {n: fn.launches for n, fn in kernel_fns.items()}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"{k}.pt")
                 for k in ("ref", "grads", "updates", "batches")}
        torch.save({n: w.cpu() for n, w in w_ref.items()}, paths["ref"])
        torch.save(g_ref, paths["grads"])
        torch.save(moved, paths["updates"])
        torch.save([{k: x.cpu() for k, x in b.items()} for b in batches],
                   paths["batches"])
        del state, params, w0, w_ref, g_ref, batches, data
        torch.cuda.empty_cache()
        held_gib = torch.cuda.memory_allocated() / 2**30
        reserved_gib = torch.cuda.memory_reserved() / 2**30
        t0 = time.perf_counter()
        outs = run_children(MESH_CHILD, math.prod(MESH_AXES), {
            "MESH_AXES": ",".join(map(str, MESH_AXES)),
            "MESH_ARCHS": ",".join(MESH_ARCHS), "MESH_SEED": str(SEED),
            "MESH_FULL_ARCH": FULL_ARCH,
            "MESH_FULL_STEPS": str(MESH_FULL_STEPS),
            "MESH_FULL_LR": repr(MESH_FULL_LR), "MESH_REF": paths["ref"],
            "MESH_REF_GRADS": paths["grads"],
            "MESH_REF_UPDATES": paths["updates"],
            "MESH_BATCHES": paths["batches"],
            # four processes' caching allocators share one card: segments
            # that grow in place leave less of it stranded
            "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
        children_s = time.perf_counter() - t0
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("MESH_CHILD "))[11:])
               for out in outs]
    # the path's own count: the four ranks' sharded steps
    for name in kernel_fns:
        by_path[name]["mesh_train"] = sum(r["launches"][name]
                                          for r in reports)
    tiny = reports[0]["tiny"]
    lead = reports[0]
    losses = lead["full_losses"]
    loss_rel = max(abs(a / b - 1.0) for a, b in zip(losses, ref_losses))
    worst_half_grad = min(half_grad, key=half_grad.get)
    worst_half_update = min(half_update, key=half_update.get)
    log("mesh", ranks=len(reports), mesh="x".join(map(str, MESH_AXES)),
        device="cuda:0 (one card)", backend="gloo",
        transport=repr(mesh_mod.GLOO_ALL_GATHER),
        tiny=json.dumps({a: {k: float(f"{v:.3e}") for k, v in e.items()}
                         for a, e in tiny.items()}).replace(" ", ""),
        tiny_tol=f"loss {MESH_LOSS_TOL}, weights {MESH_PARAM_TOL} (lr 3e-4, "
                 f"warmup 1), gradients {MESH_GRAD_TOL} of each leaf's max; "
                 f"the half-batch gradients must exceed it")
    log("mesh_full", model=cfg.name, layers=cfg.n_layers, seq=FULL_SEQ,
        batch=FULL_BATCH, steps=MESH_FULL_STEPS, ref_losses=ref_losses,
        losses=losses, loss_rel=f"{loss_rel:.3e}",
        ref_step_ms=json.dumps([round(t, 1) for t in ref_ms]))
    log("mesh_full", grad_err=f"{lead['full_grad_err']:.3e}",
        grad_leaf=lead["full_grad_leaf"],
        update_err=f"{lead['full_update_err']:.3e}",
        update_leaf=lead["full_update_leaf"],
        unmoved_leaves=lead["full_unmoved_leaves"],
        tol=f"loss {MESH_FULL_LOSS_RTOL} rel, gradients "
            f"{MESH_FULL_GRAD_TOL} of each leaf's max, updates "
            f"{MESH_FULL_UPDATE_TOL} of each leaf's")
    log("mesh_full_control", half_batch_grad_err_min=(
            f"{half_grad[worst_half_grad]:.3e}"),
        half_batch_grad_err_median=f"{np.median(list(half_grad.values())):.3e}",
        grad_leaf=worst_half_grad,
        half_batch_update_err_min=f"{half_update[worst_half_update]:.3e}",
        half_batch_update_err_median=(
            f"{np.median(list(half_update.values())):.3e}"),
        update_leaf=worst_half_update)
    for r in reports:
        log("mesh_rank", rank=r["rank"],
            step_ms=json.dumps([round(t, 1) for t in r["full_step_ms"]]),
            peak_GiB=f"{r['full_peak_GiB']:.2f}",
            reserved_GiB=f"{r['full_reserved_GiB']:.2f}",
            coll_bytes_first_step=json.dumps(
                r["full_coll_bytes_first_step"]).replace(" ", ""),
            launches=json.dumps(r["launches"]).replace(" ", ""))
    log("mesh", held_by_parent_GiB=f"{held_gib:.2f}",
        reserved_by_parent_GiB=f"{reserved_gib:.2f}",
        children_s=f"{children_s:.1f}",
        launches=json.dumps({n: by_path[n]["mesh_train"]
                             for n in kernel_fns}).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    if any(parent_launches.values()) or any(
            by_path[n]["mesh_train"] for n in kernel_fns):
        raise AssertionError(f"a kernel was launched on the mesh path: "
                             f"{parent_launches}, {[r['launches'] for r in reports]}")
    for arch, e in tiny.items():
        if not (e["loss_err"] < MESH_LOSS_TOL
                and e["param_err"] < MESH_PARAM_TOL
                and e["grad_err"] <= MESH_GRAD_TOL):
            raise AssertionError(f"{arch}: the sharded step differs from "
                                 f"the unsharded one: {e}")
        if not e["half_batch_grad_err"] > MESH_GRAD_TOL:
            raise AssertionError(f"{arch}: the half-batch control passes "
                                 f"the gradient bar: {e}")
    if not (loss_rel <= MESH_FULL_LOSS_RTOL
            and lead["full_grad_err"] <= MESH_FULL_GRAD_TOL
            and lead["full_update_err"] <= MESH_FULL_UPDATE_TOL):
        raise AssertionError(f"{FULL_ARCH} on the mesh: losses {losses} "
                             f"against {ref_losses}; {lead}")
    # the control: half the batch fails both bars on every leaf
    if not (half_grad[worst_half_grad] > MESH_FULL_GRAD_TOL
            and half_update[worst_half_update] > MESH_FULL_UPDATE_TOL):
        raise AssertionError("the half-batch control passes a bar: "
                             f"{worst_half_grad} {half_grad[worst_half_grad]}"
                             f", {worst_half_update} "
                             f"{half_update[worst_half_update]}")


def phase_dryrun(dev, by_path, kernel_fns):
    """Phase 21: the dry run's pairs on the production meshes (module
    docs); ``meta`` tensors under a fake process group, nothing on the
    card."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import dryrun, hlo_cost, mesh as mesh_mod
    from repro_torch.launch import roofline
    t_phase = time.perf_counter()
    for fn in kernel_fns.values():
        fn.launches = 0
    total = torch.cuda.get_device_properties(dev).total_memory
    # this torch's DTensor counted per rank, its shape-only propagation
    # left out: a (Shard(0), Shard(1)) product on 16 x 16 is 1/256 of the
    # global 2·M·N·K, with no collective
    m_, k_, n_ = 256, 4096, 14336
    with dryrun.fake_world(256):
        mesh = mesh_mod.make_production_mesh()
        x = distribute_tensor(torch.empty(m_, k_, dtype=torch.bfloat16,
                                          device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(k_, n_, dtype=torch.bfloat16,
                                          device="meta"), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        with hlo_cost.CostMode() as mode:
            x @ w
    if not (mode.cost.flops == 2.0 * m_ * n_ * k_ / 256
            and mode.cost.coll_bytes == {}):
        raise AssertionError(f"hlo_cost's per-rank count: {mode.cost}")
    for arch, shape, multi_pod in DRYRUN_PAIRS:
        rec = dryrun.run_pair(arch, shape, multi_pod=multi_pod)
        row = roofline.roofline_row(rec)
        m, pc = rec["mem"], rec["per_chip"]
        if not (rec["ok"] and pc["flops"] > 0):
            raise AssertionError(f"the dry run of {arch} {shape}: {rec}")
        log("dryrun", pair=dryrun.pair_key(arch, shape, multi_pod),
            n_chips=rec["n_chips"], trace_s=rec["trace_s"],
            microbatches=f"{rec['traced_microbatches']}"
                         f"/{rec['microbatches']}",
            per_chip_GB=f"{m['per_chip_bytes'] / 1e9:.3f}",
            chip_hbm_GB=f"{dryrun.CHIP_HBM_BYTES / 1e9:.1f}",
            fits_80gb=m["fits_80gb"], flops=f"{pc['flops']:.4e}",
            write_bytes=f"{pc['write_bytes']:.4e}",
            collective_bytes=json.dumps(
                {k: f"{v:.4e}" for k, v in pc["collective_bytes"].items()}
            ).replace(" ", ""))
        log("dryrun_roofline", pair=dryrun.pair_key(arch, shape, multi_pod),
            compute_s=f"{row['compute_s']:.4e}",
            memory_s=f"{row['memory_s']:.4e}",
            collective_s=f"{row['collective_s']:.4e}",
            dominant=row["dominant"],
            useful_ratio=f"{row['useful_ratio']:.3f}",
            lever=repr(roofline.lever(row)))
    for name, fn in kernel_fns.items():
        by_path[name]["dryrun"] = fn.launches
    log("dryrun", card_total_memory_GB=f"{total / 1e9:.3f}",
        per_rank_product_flops=f"{mode.cost.flops:.4e}",
        chip_hbm_bytes=f"{dryrun.CHIP_HBM_BYTES:.0f}",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def _sweep_parts(x):
    """(iterations, Γ landscape, allocation, splits) of a ``GDResult``
    (splits: each lane's argmin over the layers) or a ``LiGDOutcome``."""
    if hasattr(x, "iters_by_layer"):
        return (torch.as_tensor(x.iters_by_layer),
                torch.as_tensor(x.gamma_by_layer), x.alloc,
                torch.as_tensor(x.s))
    return x.iters.cpu(), x.gamma.cpu(), x.alloc, x.gamma.argmin(-1).cpu()


def graphed_vs_eager(got, want, what):
    """Equal iteration counts and splits; Γ and every allocation leaf
    bitwise, else within ``GRAPH_RTOL``.  Returns (bitwise, Γ's largest
    relative difference, the largest leaf difference over its max)."""
    (gi, gg, ga, gs), (wi, wg, wa, ws) = _sweep_parts(got), _sweep_parts(want)
    if not (torch.equal(gi, wi) and torch.equal(gs, ws)):
        raise AssertionError(f"{what}: iteration counts or splits differ")
    g_rel = float(((gg.double() - wg.double()).abs()
                   / wg.double().abs()).max())
    a_rel = max(scaled_err(x, y) for x, y in zip(ga, wa))
    bitwise = torch.equal(gg, wg) and all(torch.equal(x, y)
                                          for x, y in zip(ga, wa))
    if not bitwise and not (g_rel <= GRAPH_RTOL and a_rel <= GRAPH_RTOL):
        raise AssertionError(f"{what}: Γ {g_rel:.3e} and leaves {a_rel:.3e}"
                             f" apart, bar {GRAPH_RTOL}")
    return bitwise, g_rel, a_rel


def log_graph_pool(dev, after):
    """The compiled sweep's cached runners and graph pool, beside all the
    card's allocator holds, after the phase ``after``."""
    from repro_torch.core import sweep_graph
    log("graph_pool", after=after, runners=len(sweep_graph.cached_keys()),
        pool_reserved_bytes=sweep_graph.pool_reserved_bytes(dev),
        card_reserved_bytes=torch.cuda.memory_reserved(dev))


def phase_graphed_sweep(dev, by_path):
    """Phase 22: the compiled sweep on the card (module docs)."""
    from repro_torch.core import era, ligd, network, profiles, sweep_graph
    from repro_torch.kernels.era_step.kernel import era_step_fused
    from repro_torch.kernels.noma_rate.kernel import noma_rate
    from repro_torch.serving.cluster import SplitInferenceCluster
    t_phase = time.perf_counter()
    w = era.Weights()
    # the faithful counterpart of lax.while_loop would be a conditional
    # WHILE node: what this torch exposes of conditional capture
    cond_api = [a for a in dir(torch.cuda.CUDAGraph)
                if "conditional" in a or "capture_to" in a]

    def timed(prep, q, x_init, graphed, **kw):
        torch.cuda.synchronize()
        ligd.SWEEP_STATS.update(flag_reads=0, replays=0, captures=0,
                                warmup_launches=0)
        n0 = era_step_fused.launches
        t0 = time.perf_counter()
        with torch.no_grad():
            out = ligd._sweep_core(prep.scn_b, q, x_init, prep.pred_b,
                                   kw.pop("lr", 0.05), kw.pop("tol", 1e-5),
                                   kw.pop("max_steps", MAX_STEPS), w,
                                   prep.prof_b, graphed=graphed, **kw)
        torch.cuda.synchronize()
        return dict(out=out, s=time.perf_counter() - t0,
                    launches=era_step_fused.launches - n0,
                    **ligd.SWEEP_STATS)

    def per_step(run):
        return f"{run['s'] / max(run['launches'], 1) * 1e3:.4f}"

    # (a) phase 6's sweep (two paper-width cells, yolov2, chunked, 400
    # steps), graphed (the first run captures) and eager on the same inputs
    cfg, scns = paper_cells(network, 2, dev)
    prof = profiles.get_profile("yolov2", device=dev)
    q = torch.full((2, cfg.n_users), 0.4, device=dev)
    chunk = dict(check_every=ligd.DEFAULT_GD_CHUNK)
    prep = ligd.prepare_batch(scns, prof)
    x_init = era.uniform_alloc(prep.scn_b)
    first = timed(prep, q, x_init, True, **chunk)
    graphed = timed(prep, q, x_init, True, **chunk)
    eager = timed(prep, q, x_init, False, **chunk)
    same_a, g_rel_a, a_rel_a = graphed_vs_eager(graphed["out"], eager["out"],
                                                "(a) graphed sweep")
    # the first run's capture warm-ups launched era_step too, outside its
    # replays
    if not (graphed["launches"] == eager["launches"]
            == first["launches"] - first["warmup_launches"]
            and graphed["captures"] == 0):
        raise AssertionError(f"(a) era_step launches graphed "
                             f"{graphed['launches']}, eager "
                             f"{eager['launches']}, first "
                             f"{first['launches']} with "
                             f"{first['warmup_launches']} in warm-ups; "
                             f"captures {graphed['captures']} on the "
                             f"second run")
    log("graphed_sweep", part="a", cells=2,
        shape=f"U{cfg.n_users}xM{cfg.n_subchannels}xN{cfg.n_aps}",
        profile="yolov2", check_every=chunk["check_every"],
        max_steps=MAX_STEPS, bitwise=same_a, gamma_rel=f"{g_rel_a:.3e}",
        leaf_rel=f"{a_rel_a:.3e}", steps=graphed["launches"],
        era_launches_graphed=graphed["launches"],
        era_launches_eager=eager["launches"],
        graphed_first_s=f"{first['s']:.3f}", captures=first["captures"],
        warmup_launches=first["warmup_launches"],
        graphed_s=f"{graphed['s']:.3f}", eager_s=f"{eager['s']:.3f}",
        graphed_ms_per_step=per_step(graphed),
        eager_ms_per_step=per_step(eager),
        replays=graphed["replays"], flag_reads_graphed=graphed["flag_reads"],
        flag_reads_eager=eager["flag_reads"],
        conditional_node_api=json.dumps(cond_api).replace(" ", ""))

    # the count against the device: a graphed sweep at a budget no runner
    # has yet (a capture, its warm-up, then replays) under the profiler;
    # pass0 runs once an era_step launch, so its records are the launches
    # the device ran, which the count must equal
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        counted = timed(prep, q, x_init, True, max_steps=COUNT_STEPS, **chunk)
    records = [e for e in trace.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    pass0 = sum(1 for e in records if "pass0_kernel" in e.name())
    log("graphed_sweep", part="count", max_steps=COUNT_STEPS,
        captures=counted["captures"], replays=counted["replays"],
        warmup_launches=counted["warmup_launches"],
        era_launches=counted["launches"], pass0_records=pass0,
        device_records=len(records))
    if not (counted["captures"] and pass0 == counted["launches"]
            > counted["warmup_launches"] > 0):
        raise AssertionError(f"(a) a profiled graphed sweep ran pass0 "
                             f"{pass0} times; era_step's count says "
                             f"{counted['launches']}, "
                             f"{counted['warmup_launches']} of them in "
                             f"{counted['captures']} captures' warm-ups")

    # (b) the cells' channels drawn again (phase 6's observe step) through
    # the cached runner: no capture, equal to an eager solve of them; each
    # lane's Γ landscape moved by more than the bar, so stale buffers fail
    gen = torch.Generator().manual_seed(SEED + 300)
    scns2 = [network.evolve_scenario(s_, gen, rho=0.5) for s_ in scns]
    prep2 = ligd.prepare_batch(scns2, prof)
    x_init2 = era.uniform_alloc(prep2.scn_b)
    eager2 = timed(prep2, q, x_init2, False, **chunk)
    moved = ((eager2["out"].gamma.double() - eager["out"].gamma.double()).abs()
             / eager["out"].gamma.double().abs()).amax(dim=1)
    if not bool((moved > GRAPH_RTOL).all()):
        raise AssertionError(f"(b) the redrawn channels moved a lane's Γ "
                             f"landscape by only {moved.tolist()}")
    n_runners = len(sweep_graph.cached_keys())
    graphed2 = timed(prep2, q, x_init2, True, **chunk)
    same_b, g_rel_b, a_rel_b = graphed_vs_eager(graphed2["out"],
                                                eager2["out"],
                                                "(b) second scenario")
    if graphed2["captures"] or len(sweep_graph.cached_keys()) != n_runners:
        raise AssertionError("(b) the second scenario did not reuse the "
                             "cached runner")
    if graphed2["launches"] != eager2["launches"]:
        raise AssertionError(f"(b) era_step launches graphed "
                             f"{graphed2['launches']}, eager "
                             f"{eager2['launches']}")
    log("graphed_sweep", part="b", bitwise=same_b,
        gamma_rel=f"{g_rel_b:.3e}", leaf_rel=f"{a_rel_b:.3e}",
        landscape_moved_min=f"{float(moved.min()):.3e}",
        steps=graphed2["launches"], graphed_s=f"{graphed2['s']:.3f}",
        eager_s=f"{eager2['s']:.3f}", graphed_ms_per_step=per_step(graphed2),
        eager_ms_per_step=per_step(eager2), replays=graphed2["replays"],
        flag_reads_graphed=graphed2["flag_reads"], captures=0)

    # (c) one cell through ``ligd.solve``: the eager per-layer loop
    # (compiled_sweep=False) against the default spec
    spec = ligd.SolverSpec()
    t0 = time.perf_counter()
    one_g = ligd.solve(scns[0], prof, q[0], spec=spec)
    torch.cuda.synchronize()
    t_g = time.perf_counter() - t0
    t0 = time.perf_counter()
    one_e = ligd.solve(scns[0], prof, q[0],
                       spec=spec.replace(compiled_sweep=False))
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    same_c, g_rel_c, a_rel_c = graphed_vs_eager(one_g, one_e,
                                                "(c) one cell, solve")
    if not torch.equal(one_g.terms.gamma, one_e.terms.gamma) and not (
            gamma_rel([one_g], [one_e]) <= GRAPH_RTOL):
        raise AssertionError("(c) the final Γ differs beyond the bar")
    log("graphed_sweep", part="c", backend=spec.backend,
        max_steps=spec.max_steps, bitwise=same_c, gamma_rel=f"{g_rel_c:.3e}",
        leaf_rel=f"{a_rel_c:.3e}", gd_iters=one_g.total_iters,
        compiled_s=f"{t_g:.3f}", eager_loop_s=f"{t_e:.3f}")

    # (d) the other bodies at phase 5's small config, graphed against eager
    small = network.small_config(n_users=12, n_subchannels=6)
    sscns = [network.make_scenario(torch.Generator().manual_seed(50 + i),
                                   small, dev) for i in range(4)]
    sprep = ligd.prepare_batch(sscns, profiles.get_profile("nin",
                                                           device=dev))
    sq = torch.full((4, small.n_users), 0.4, device=dev)
    sx = era.uniform_alloc(sprep.scn_b)
    bodies = {}
    for name, kw in (("autograd", dict(step_impl="autograd")),
                     ("adaptive", dict(adaptive=True))):
        kw.update(tol=0.0, max_steps=BODY_STEPS)
        g_run = timed(sprep, sq, sx, True, **dict(kw))
        e_run = timed(sprep, sq, sx, False, **dict(kw))
        same, g_rel, a_rel = graphed_vs_eager(g_run["out"], e_run["out"],
                                              f"(d) {name}")
        if g_run["launches"] - g_run["warmup_launches"] != e_run["launches"]:
            raise AssertionError(f"(d) {name}: era_step launches differ")
        # one step a replay (check_every 1), and as many steps eagerly
        steps = g_run["replays"]
        bodies[name] = dict(bitwise=same, gamma_rel=float(f"{g_rel:.3e}"),
                            leaf_rel=float(f"{a_rel:.3e}"), steps=steps,
                            graphed_ms_per_step=round(
                                g_run["s"] / steps * 1e3, 4),
                            eager_ms_per_step=round(
                                e_run["s"] / steps * 1e3, 4))
        if name == "autograd":
            # the eager loop against itself: the backward of autograd's
            # gathers is a scatter-add, summed with atomics in a
            # run-dependent order
            again = timed(sprep, sq, sx, False, **dict(kw))
            same_e, g_rel_e, _ = graphed_vs_eager(
                again["out"], e_run["out"], "(d) autograd, eager twice")
            bodies[name].update(eager_twice_bitwise=same_e,
                                eager_twice_gamma_rel=float(f"{g_rel_e:.3e}"))
    torch.cuda.synchronize()
    log("graphed_sweep", part="d", cells=4, users=small.n_users,
        channels=small.n_subchannels, max_steps=BODY_STEPS,
        bodies=json.dumps(bodies).replace(" ", ""),
        pool_reserved_bytes=sweep_graph.pool_reserved_bytes(dev),
        runners=len(sweep_graph.cached_keys()))

    # (e) the main path on the default: bootstrap and an admission round of
    # phase 6's cluster, then a second round under the profiler
    spec = ligd.SolverSpec(backend="chunked", per_user_split=True,
                           max_steps=MAX_STEPS)
    cluster = SplitInferenceCluster(None, None, prof, spec=spec, device=dev)
    a_id, b_id = (cluster.add_cell(s_) for s_ in scns)
    era_step_fused.launches = 0
    noma_rate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cluster.start(threaded=False)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    boot_steps = era_step_fused.launches

    def admission_round(k):
        """Arrivals on cell a, a drift of cell b, one round: (wall s, GD
        steps)."""
        for user, q_s in ((3 + k, 0.25), (17 + k, 0.3), (400 + k, 0.2)):
            cluster.submit(a_id, user=user, q_s=q_s)
        cluster.observe(b_id, network.evolve_scenario(
            scns[1], torch.Generator().manual_seed(SEED + 200 + k), rho=0.5))
        n0 = era_step_fused.launches
        t0 = time.perf_counter()
        if cluster.step() is None:
            raise AssertionError(f"(e) admission round {k} did not run")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, era_step_fused.launches - n0

    t_round, round_steps = admission_round(0)
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t_prof, prof_steps = admission_round(1)
    by_path["era_step"]["graphed_sweep"] = era_step_fused.launches
    by_path["noma_rate"]["graphed_sweep"] = noma_rate.launches
    cluster.stop()
    for name in ("era_step", "noma_rate"):
        if by_path[name]["graphed_sweep"] <= 0:
            raise AssertionError(f"(e) {name} was not launched")
    # the raw device records (building the profiler's event tree takes
    # minutes for a round's records); pass0 runs once an era_step launch
    dev_events = [e for e in trace.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
    busy_s = sum(e.duration_ns() for e in dev_events) / 1e9
    # short of the count when the round's records overflow the profiler's
    # buffers (the count is held to the device on (a)'s smaller window)
    pass0 = sum(1 for e in dev_events if "pass0_kernel" in e.name())
    by_kernel = {}
    for e in dev_events:
        k = short_name(e.name())
        by_kernel[k] = by_kernel.get(k, 0) + e.duration_ns() / 1e9
    era_s = sum(by_kernel.get(k, 0.0) for k in ERA_KERNELS)
    top = sorted(((k, v) for k, v in by_kernel.items()
                  if k not in ERA_KERNELS), key=lambda kv: -kv[1])[:6]
    log("graphed_sweep", part="e", bootstrap_s=f"{t_boot:.3f}",
        bootstrap_steps=boot_steps,
        bootstrap_ms_per_step=f"{t_boot / boot_steps * 1e3:.4f}",
        round_s=f"{t_round:.3f}", round_steps=round_steps,
        round_ms_per_step=f"{t_round / max(round_steps, 1) * 1e3:.4f}",
        profiled_round_s=f"{t_prof:.3f}", profiled_round_steps=prof_steps,
        device_busy_s=f"{busy_s:.3f}",
        device_busy_share=f"{busy_s / t_prof:.3f}",
        profiled_pass0_records=pass0, device_records=len(dev_events),
        era_step_device_s=f"{era_s:.3f}",
        era_step_ms_per_step=f"{era_s / max(prof_steps, 1) * 1e3:.4f}",
        other_device_ms_per_step=(
            f"{(busy_s - era_s) / max(prof_steps, 1) * 1e3:.4f}"),
        top_other_kernels_s=json.dumps([[k, round(v, 3)] for k, v in top]
                                       ).replace(" ", ""),
        launches=json.dumps({n: by_path[n]["graphed_sweep"]
                             for n in ("era_step", "noma_rate")}
                            ).replace(" ", ""),
        pool_reserved_bytes=sweep_graph.pool_reserved_bytes(dev),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")


def check_decode_call(q, k, v, slot_pos, pos, window, scale, out, where):
    """``out``, the decode-attention kernel's output for these inputs,
    against the plain version in float32: within one bf16 ulp, and no
    further off than the plain bf16 path.  Returns (its largest error,
    the plain bf16 path's, the float32 output's largest magnitude)."""
    from repro_torch.kernels.decode_attention import ref as dref
    want32 = dref.decode_attention_ref(q.float(), k.float(), v.float(),
                                       slot_pos, pos, window=window,
                                       scale=scale)
    plain = dref.decode_attention_ref(q, k, v, slot_pos, pos, window=window,
                                      scale=scale)
    err = (out.float() - want32).abs()
    plain_err = float((plain.float() - want32).abs().max())
    if not (bool((err <= BF16_ULP_ATOL + BF16_ULP_RTOL * want32.abs()).all())
            and float(err.max()) <= plain_err):
        raise AssertionError(f"{where}: decode_attention kernel is off the "
                             f"float32 plain version by {float(err.max())} "
                             f"(the plain bf16 path by {plain_err})")
    return float(err.max()), plain_err, float(want32.abs().max())


def keeping_decode_calls(kept, limit=4):
    """A stand-in for the decode-attention wrapper where the model calls
    it (``decode_attention.ops._kernel``): it calls the wrapper, and for
    the first call of each shape and window made outside graph capture
    (at most ``limit``) keeps copies of the inputs and the output in
    ``kept`` for ``checked_decode_calls``."""
    from repro_torch.kernels.decode_attention import kernel as dk

    def call(q, k, v, slot_pos, pos, *, window=0, scale=None):
        key = (tuple(q.shape), tuple(k.shape), window)
        keep = (key not in kept and len(kept) < limit
                and not torch.cuda.is_current_stream_capturing())
        args = [x.clone() for x in (q, k, v, slot_pos, pos)] if keep else ()
        out = dk.decode_attention(q, k, v, slot_pos, pos, window=window,
                                  scale=scale)
        if keep:
            kept[key] = (args, window, scale, out.clone())
        return out
    return call


def checked_decode_calls(kept, where):
    """Each call ``keeping_decode_calls`` kept, through
    ``check_decode_call``; returns one log entry a call: its shape,
    window, position, whether the ring has wrapped, its keys, and the two
    errors."""
    if not kept:
        raise AssertionError(f"{where}: no eager decode-attention call was "
                             f"kept")
    rows = []
    for (q, k, v, slot_pos, pos), window, scale, out in kept.values():
        err, plain_err, _ = check_decode_call(q, k, v, slot_pos, pos, window,
                                              scale, out, where)
        b, _, h, d = q.shape
        t, kh = k.shape[1], k.shape[2]
        now = int(pos)
        keys = (slot_pos >= 0) & (slot_pos <= now)
        if window:
            keys &= slot_pos > now - window
        rows.append(dict(shape=f"B{b}xT{t}xH{h}xK{kh}xD{d}", window=window,
                         pos=now, wrapped=now >= t, keys=int(keys.sum()),
                         f32_err=f"{err:.3e}",
                         bf16_plain_err=f"{plain_err:.3e}"))
    kept.clear()
    return rows


def phase_decode_attention(dev):
    """Phase 23: the decode-attention kernel at the decode shape of the
    benchmark's mixtral-8x22b.prefill4608 cell (module docs).  Returns its
    entry of the kernels' JSON line."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dref
    t_phase = time.perf_counter()
    # the benchmark cell's: 8 users of one cell, a 4608-token prompt, global
    # attention; the ring of 4617 slots (the prompt, 8 greedy tokens and
    # one more) at the first further step
    b, t, h, kh, d, pos = 8, MOE_SEQ + 9, 48, 8, 128, MOE_SEQ
    g = torch.Generator(device=dev).manual_seed(SEED + 2300)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev).to(
        torch.bfloat16)
    q, k, v = rn(b, 1, h, d), rn(b, t, kh, d), rn(b, t, kh, d)
    slots = torch.arange(t, device=dev)
    slot_pos = torch.where(slots <= pos, slots, -1)
    now = torch.tensor(pos, device=dev)
    scale = 1.0 / math.sqrt(d)
    out = dk.decode_attention(q, k, v, slot_pos, now)
    err, plain_err, out_max = check_decode_call(q, k, v, slot_pos, now, 0,
                                                scale, out, "phase 23")
    valid = (slot_pos >= 0) & (slot_pos <= now)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=valid[None, None, None, :], scale=scale,
        enable_gqa=True)
    lib = sdpa().transpose(1, 2)
    sdpa_diff = float((lib.float() - out.float()).abs().max())

    call = lambda: dk.decode_attention(q, k, v, slot_pos, now)
    ev_ms = cuda_ms(call, reps=50)
    t0 = time.perf_counter()
    for _ in range(50):
        call()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    k_ms = graph_ms(call)
    p_ms = cuda_ms(lambda: dref.decode_attention_ref(q, k, v, slot_pos, now,
                                                     scale=scale), reps=10)
    lib_ms = cuda_ms(sdpa, reps=50)
    # its device time at other splits of the keys (the wrapper's choice
    # is the fewest splits that give two blocks a multiprocessor)
    tiles = -(-t // dk.TILE)
    by_split = {}
    for per in sorted({-(-tiles // n) for n in (1, 2, 3, 5, 7, 9, 13, 19,
                                                 25, 37, tiles)}):
        n = -(-tiles // per)
        by_split[n] = round(graph_ms(lambda: dk._launch(
            q, k, v, slot_pos, now, 0, scale, n, per)), 4)
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (q, k, v, out, slot_pos))
    n_ops = 4.0 * d * b * h * (pos + 1)
    bnd, by = bound_ms(n_bytes, n_ops, BF16_FLOPS_S)
    usage = {re.search(r"decode_\w+?_kernel(ILi\d+E)?", n_).group(0): u_
             for n_, u_ in _build.ptxas_usage("decode_attention").items()}
    spilled = {n_: u_ for n_, u_ in usage.items() if u_[1] or u_[2]}
    if spilled:
        raise AssertionError(f"decode_attention instantiations spill "
                             f"(registers, store, load bytes): {spilled}")
    splits, per = dk.splits_for(b * kh, t, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log("decode_attention", shape=f"B{b}xT{t}xH{h}xK{kh}xD{d}", pos=pos,
        splits=f"{splits}x{per}tiles", kernel_ms=f"{k_ms:.4f}",
        event_ms=f"{ev_ms:.4f}", host_ms=f"{host_ms:.4f}",
        bound_ms=f"{bnd:.4f}", bound_by=by, MB_moved=f"{n_bytes / 1e6:.2f}",
        roofline_pct=f"{100 * bnd / k_ms:.1f}", plain_ms=f"{p_ms:.4f}",
        sdpa_ms=f"{lib_ms:.4f}",
        sdpa_max_abs_diff=f"{sdpa_diff:.3e}",
        f32_plain_max_abs_err=f"{err:.3e}",
        bf16_plain_max_abs_err=f"{plain_err:.3e}",
        ms_by_splits=json.dumps(by_split).replace(" ", ""),
        ptxas_regs_spill_st_ld=json.dumps(usage).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/csrc/decode_attention.cu",
                replaces="none: src/repro/models/attention.py:248 is plain "
                         "jnp",
                max_abs_err=err, max_scaled_err=err / out_max,
                ms=k_ms, event_ms=ev_ms, plain_ms=p_ms, bound_ms=bnd,
                bound_by=by, library_ms=lib_ms)


def attn_inputs(dev, b, s_len, h, kh, d, dtype, seed, qk_gain=1.0):
    """q, k, v (B, S, heads, D) from the seed; q and k times ``qk_gain``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = [torch.randn(shape, generator=g, device=dev)
               for shape in ((b, s_len, h, d), (b, s_len, kh, d),
                             (b, s_len, kh, d))]
    return [x.to(dtype) for x in (q * qk_gain, k * qk_gain, v)]


def folded(q, k, v):
    """The kernel's (B·H, S, D) operands, folded once outside the
    timed calls."""
    fold = lambda x: x.transpose(1, 2).reshape(
        -1, x.shape[1], x.shape[3]).contiguous()
    return fold(q), fold(k), fold(v)


def attn_check(q, k, v, window, tol, scale=None, rows=None):
    """The flash kernel against its plain version on the same inputs,
    within ``tol`` absolute plus relative; bf16 inputs are also held
    against the plain version in float32 within one bf16 ulp of the
    output (the kernel's sums are float32, P enters P·V as its bf16 head
    and remainder, and only its output is rounded).  The plain versions
    run ``rows`` batch rows at a time (all at once by default: their
    float32 scores take B·H·S² · 4 bytes).
    Returns the kernel's output, its max abs difference from the plain
    version, that version's max |o|, and the float32 difference."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    out_k = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                   scale=scale)
    rows = rows or q.shape[0]
    err, o_max, err32 = 0.0, 0.0, None
    for r in range(0, q.shape[0], rows):
        qr, kr, vr, got = (x[r:r + rows] for x in (q, k, v, out_k))
        out_p = fa_ref.attention_ref(qr, kr, vr, causal=True, window=window,
                                     scale=scale).float()
        torch.cuda.synchronize()
        diff = (got.float() - out_p).abs()
        if not bool((diff <= tol + tol * out_p.abs()).all()):
            raise AssertionError(f"flash_attention kernel disagrees with its "
                                 f"plain version: max abs err "
                                 f"{float(diff.max())}, tolerance {tol}")
        err = max(err, float(diff.max()))
        o_max = max(o_max, float(out_p.abs().max()))
        del out_p, diff
        if q.dtype == torch.bfloat16:
            out_32 = fa_ref.attention_ref(qr.float(), kr.float(), vr.float(),
                                          causal=True, window=window,
                                          scale=scale)
            d32 = (got.float() - out_32).abs()
            if not bool((d32 <= BF16_ULP_ATOL
                         + BF16_ULP_RTOL * out_32.abs()).all()):
                raise AssertionError(
                    f"flash_attention kernel (bf16) is more than one bf16 "
                    f"ulp from its plain version in float32: max abs err "
                    f"{float(d32.max())}")
            err32 = max(err32 or 0.0, float(d32.max()))
            del out_32, d32
    return out_k, err, o_max, err32


def ssd_inputs(dev, bt, l, h, p, n, dtype, seed):
    """mamba2-780m's operands: dt from a softplus (mean ~0.05, as
    softplus(dt_raw + dt_bias) with the init's dt_bias), A = -(1..h),
    D = 1; x, B and C in ``dtype``."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = rn(bt, l, h, p).to(dtype)
    dt = F.softplus(rn(bt, l, h) - 3.0)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    b, c = (rn(bt, l, n) * 0.5).to(dtype), (rn(bt, l, n) * 0.5).to(dtype)
    return x, dt, a, b, c, torch.ones(h, device=dev)


def ssd_check(args, chunk, plain, what):
    """The ssd kernel against ``plain`` (float32 math) on the same inputs:
    a float32 y within 1e-4 of max |y|, a bf16 y within one bf16 ulp of
    the output (2^-7 rel + 1e-4 abs); the state within 1e-4 of max
    |state|.  Returns (max abs err, max scaled err)."""
    from repro_torch.kernels.ssd import ops as ssd_ops
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


def phase_granite(dev):
    """Phase 24: the three model kernels at the shapes and score scale of
    the benchmark's granite-4.0-h-small.prefill4096 cell, each against its
    plain version (module docs).  Logs one line; raises where a kernel
    misses its bar (the ssd's after the line is logged)."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bshd
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd.kernel import ssd_scan
    t_phase = time.perf_counter()
    b, s_len, h, kh, d = GRANITE_USERS, GRANITE_SEQ, 32, 8, 128
    scale = 1.0 / d
    # flash: NoPE (nothing rotates q and k), global causal attention,
    # scores x 1/head_dim; q and k x 128^(1/4), as the cell's weights
    # draw them, so that the scores spread (std ~1) under that scale
    gain = d ** 0.25
    q, k, v = attn_inputs(dev, b, s_len, h, kh, d, torch.bfloat16,
                          SEED + 2401, qk_gain=gain)
    _, fa_err, _, fa_err32 = attn_check(q, k, v, 0, 2e-2, scale=scale,
                                        rows=2)
    fa_ms = cuda_ms(lambda: flash_attention_bshd(q, k, v, causal=True,
                                                 scale=scale), reps=10)
    fa_flop = 2.0 * b * h * d * s_len * (s_len + 1)
    del q, k, v
    # decode attention at the first step past the prompt: a ring of the
    # prompt, 8 greedy tokens and one more
    t, pos = s_len + 9, s_len
    g = torch.Generator(device=dev).manual_seed(SEED + 2402)
    rn = lambda *sh: torch.randn(sh, generator=g, device=dev)
    q = (rn(b, 1, h, d) * gain).to(torch.bfloat16)
    k = (rn(b, t, kh, d) * gain).to(torch.bfloat16)
    v = rn(b, t, kh, d).to(torch.bfloat16)
    slots = torch.arange(t, device=dev)
    slot_pos = torch.where(slots <= pos, slots, -1)
    now = torch.tensor(pos, device=dev)
    out = dk.decode_attention(q, k, v, slot_pos, now, scale=scale)
    da_err, da_plain, _ = check_decode_call(q, k, v, slot_pos, now, 0, scale,
                                            out, "phase 24")
    da_ms = cuda_ms(lambda: dk.decode_attention(q, k, v, slot_pos, now,
                                                scale=scale), reps=50)
    del q, k, v, out
    # the ssd at the Mamba-2 layers' 128 heads (A down to -128), against
    # the plain chunked version in float32 (phase 10's bar) and in
    # float64, which also shows where the float32 version misses it; a
    # row at a time
    shape = (b, s_len, 128, 64, 128)
    x, dt, a, bm, cm, dd = sargs = ssd_inputs(dev, *shape, torch.bfloat16,
                                              SEED + 2400)
    y_k, s_k = ssd_scan(*sargs, chunk=256)
    ssd_ms = cuda_ms(lambda: ssd_scan(*sargs, chunk=256), reps=10)
    f64 = lambda *v_: [u.double() for u in v_]
    miss = dict(kernel_vs_f32=0, kernel_vs_f64=0, f32_vs_f64=0)
    worst = dict.fromkeys(miss, 0.0)        # the largest error over its bar
    s_err = y_err = 0.0
    for r in range(b):
        sl = slice(r, r + 1)
        y32, s32 = ssd_ref.ssd_chunked(x[sl].float(), dt[sl], a,
                                       bm[sl].float(), cm[sl].float(), dd,
                                       chunk=256)
        y64, _ = ssd_ref.ssd_chunked(*f64(x[sl], dt[sl], a, bm[sl], cm[sl],
                                          dd), chunk=256)
        got = y_k[sl].double()
        for name, have, want in (("kernel_vs_f32", got, y32.double()),
                                 ("kernel_vs_f64", got, y64),
                                 ("f32_vs_f64", y32.double(), y64)):
            ratio = (have - want).abs() / (BF16_ULP_ATOL
                                           + BF16_ULP_RTOL * want.abs())
            miss[name] += int((ratio > 1).sum())
            worst[name] = max(worst[name], float(ratio.max()))
        y_err = max(y_err, float((got - y32.double()).abs().max()))
        s_err = max(s_err, float((s_k[sl] - s32).abs().max())
                    / float(s32.abs().max()))
        del y32, s32, y64, got
    del sargs, x, dt, bm, cm, y_k, s_k
    log("granite_kernels",
        flash_shape=f"B{b}xS{s_len}xH{h}xK{kh}xD{d}", flash_scale=scale,
        flash_qk_gain=f"{gain:.4f}", flash_max_abs_err=f"{fa_err:.3e}",
        flash_f32_plain_max_abs_err=f"{fa_err32:.3e}",
        flash_event_ms=f"{fa_ms:.4f}",
        flash_TFLOP_s=f"{fa_flop / fa_ms / 1e9:.1f}",
        decode_shape=f"B{b}xT{t}xH{h}xK{kh}xD{d}", decode_pos=pos,
        decode_scale=scale, decode_f32_plain_max_abs_err=f"{da_err:.3e}",
        decode_bf16_plain_max_abs_err=f"{da_plain:.3e}",
        decode_event_ms=f"{da_ms:.4f}",
        ssd_shape="B{}xL{}xH{}xP{}xN{}".format(*shape), ssd_chunk=256,
        ssd_max_abs_err=f"{y_err:.3e}", ssd_state_scaled_err=f"{s_err:.3e}",
        ssd_elements=b * s_len * 128 * 64,
        ssd_over_bar=json.dumps(miss).replace(" ", ""),
        ssd_worst_err_over_bar=json.dumps(
            {n_: round(w_, 3) for n_, w_ in worst.items()}).replace(" ", ""),
        ssd_event_ms=f"{ssd_ms:.4f}",
        tol=f"{BF16_ULP_RTOL:.4g}_rel+{BF16_ULP_ATOL:g}_abs",
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    if miss["kernel_vs_f32"] or s_err > 1e-4:
        raise AssertionError(
            f"ssd kernel at granite's shape is more than one bf16 ulp from "
            f"its plain version in float32 at {miss['kernel_vs_f32']} of "
            f"{b * s_len * 128 * 64} outputs (worst "
            f"{worst['kernel_vs_f32']:.3f}x the bar; the float32 version "
            f"misses the float64 one at {miss['f32_vs_f64']}), state "
            f"{s_err:.3e} of its max: where |A|·Σdt in a chunk reaches "
            f"~1e3, differences of the in-chunk cumsum lose float32 "
            f"precision (ROADMAP queue 1)")


# phase 25: the Mamba-2 serve cells' shapes: (config, users, tokens), the
# prefill's and then the decode step's (one token: the gate kernel's only
# decode call; the conv there is the plain path's)
MIXER_SHAPES = (("mamba2-780m", SERVE_USERS, MAMBA_SEQ),
                ("granite-4.0-h-small", GRANITE_USERS, GRANITE_SEQ),
                ("mamba2-780m", SERVE_USERS, 1),
                ("granite-4.0-h-small", GRANITE_USERS, 1))


def mixer_check(got, plain, want):
    """(outputs over one bf16 ulp of the float32 ``want``, the kernel's max
    abs error, the plain bf16 path's), a batch row at a time."""
    over, err, plain_err = 0, 0.0, 0.0
    for r in range(want.shape[0]):
        w32 = want[r]
        e = (got[r].float() - w32).abs()
        over += int((e > BF16_ULP_ATOL + BF16_ULP_RTOL * w32.abs()).sum())
        err = max(err, float(e.max()))
        plain_err = max(plain_err,
                        float((plain[r].float() - w32).abs().max()))
    return over, err, plain_err


def phase_ssm_mixer(dev):
    """Phase 25: the Mamba-2 mixer's conv and gated-norm kernels at the
    serve cells' shapes against their plain versions, their device time
    beside their byte bounds, and a whole ``ssm.prefill`` with and
    without them (module docs).  Logs a line a shape; raises where a
    kernel misses its bar or an instantiation spills.  Returns the
    kernels' entry of the JSON line: the two kernels' device time
    together, a full-sequence call's, at mamba2's shape and at
    granite's."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssm_mixer import kernel as mk
    from repro_torch.kernels.ssm_mixer import ops as mops
    from repro_torch.kernels.ssm_mixer import ref as mref
    from repro_torch.models import ssm
    from repro_torch.telemetry import spans
    t_phase = time.perf_counter()
    usage = {re.sub(r"^.*?(?=(conv_silu|gated_norm)_kernel)", "", n_)[:44]:
             u_ for n_, u_ in _build.ptxas_usage("ssm_mixer").items()}
    spills = {n_: u_ for n_, u_ in usage.items() if u_[1] or u_[2]}
    faults, at = [], {}
    for name, b, l in MIXER_SHAPES:
        cfg = configs.get_config(name)
        di, n, h = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
        dc, row = di + 2 * n, 2 * di + 2 * n + h
        g = torch.Generator(device=dev).manual_seed(SEED + 2500)
        rn = lambda *sh: torch.randn(sh, generator=g, device=dev)
        zxbcdt = rn(b, l, row).to(torch.bfloat16)
        z, xbc = zxbcdt[..., :di], zxbcdt[..., di:di + dc]
        w = (rn(cfg.conv_width, dc) / 2).to(torch.bfloat16)
        bias = (rn(dc) / 10).to(torch.bfloat16)
        y = rn(b, l, di).to(torch.bfloat16)
        norm_w = (1 + rn(di) / 10).to(torch.bfloat16)
        eps = cfg.norm_eps
        f32 = lambda *t: [u.float() for u in t]
        conv = mk.causal_conv_silu(xbc, w, bias)
        gate = mk.gated_rms_norm(y, z, norm_w, eps)
        conv_chk = mixer_check(conv, mref.causal_conv_silu_ref(xbc, w, bias),
                               mref.causal_conv_silu_ref(*f32(xbc, w, bias)))
        gate_chk = mixer_check(gate, mref.gated_rms_norm_ref(y, z, norm_w,
                                                             eps),
                               mref.gated_rms_norm_ref(*f32(y, z, norm_w),
                                                       eps))
        del conv, gate
        torch.cuda.empty_cache()
        # device ms of each kernel (a graph of 20 calls between events:
        # one launch a call), its byte bound, the plain path's event ms
        conv_ms = graph_ms(lambda: mk.causal_conv_silu(xbc, w, bias))
        gate_ms = graph_ms(lambda: mk.gated_rms_norm(y, z, norm_w, eps))
        conv_bytes = 2 * (2 * b * l * dc + (cfg.conv_width + 1) * dc)
        gate_bytes = 2 * (3 * b * l * di + di)
        conv_plain = cuda_ms(lambda: mref.causal_conv_silu_ref(xbc, w, bias),
                             reps=5)
        gate_plain = cuda_ms(
            lambda: mref.gated_rms_norm_ref(y, z, norm_w, eps), reps=5)
        del zxbcdt, z, xbc, y
        torch.cuda.empty_cache()
        # one whole prefill of a full-width layer, with and without them
        params = ssm.init(torch.Generator().manual_seed(SEED + 2501), cfg,
                          dev)
        x = rn(b, l, cfg.d_model).to(torch.bfloat16)
        with spans.enable():
            spans.clear()
            with_k, _ = ssm.prefill(params, cfg, x)
            (sp,) = [s_ for s_ in spans.finished() if s_.name == "ssm"]
            spans.clear()
        pre_ms = cuda_ms(lambda: ssm.prefill(params, cfg, x), reps=5)
        with mock.patch.object(mops, "use_kernels",
                               lambda impl, *t: False):
            without, _ = ssm.prefill(params, cfg, x)
            pre_plain = cuda_ms(lambda: ssm.prefill(params, cfg, x), reps=5)
        gap = float((with_k.float() - without.float()).abs().max()
                    / without.float().abs().max())
        del params, x, with_k, without
        torch.cuda.empty_cache()
        conv_bound = conv_bytes / HBM_BYTES_S * 1e3
        gate_bound = gate_bytes / HBM_BYTES_S * 1e3
        log("ssm_mixer", config=name, shape=f"B{b}xL{l}xDc{dc}xDi{di}",
            row_stride=row,
            conv_device_ms=f"{conv_ms:.4f}", conv_bound_ms=f"{conv_bound:.4f}",
            conv_bound_share=f"{conv_bound / conv_ms:.3f}",
            conv_plain_ms=f"{conv_plain:.4f}",
            conv_over_ulp=conv_chk[0], conv_max_abs_err=f"{conv_chk[1]:.3e}",
            conv_plain_max_abs_err=f"{conv_chk[2]:.3e}",
            gate_device_ms=f"{gate_ms:.4f}", gate_bound_ms=f"{gate_bound:.4f}",
            gate_bound_share=f"{gate_bound / gate_ms:.3f}",
            gate_plain_ms=f"{gate_plain:.4f}",
            gate_over_ulp=gate_chk[0], gate_max_abs_err=f"{gate_chk[1]:.3e}",
            gate_plain_max_abs_err=f"{gate_chk[2]:.3e}",
            prefill_ms=f"{pre_ms:.4f}", prefill_plain_ms=f"{pre_plain:.4f}",
            prefill_rel_gap=f"{gap:.3e}",
            mixer_launches=sp.fields["mixer_launches"],
            tol=f"{BF16_ULP_RTOL:.4g}_rel+{BF16_ULP_ATOL:g}_abs")
        for what, (over, err, plain_err) in (("conv", conv_chk),
                                             ("gate", gate_chk)):
            if over or err > plain_err:
                faults.append(f"{what} at {name}'s shape: {over} outputs "
                              f"over one bf16 ulp, max abs err {err:.3e} "
                              f"against the plain bf16 path's "
                              f"{plain_err:.3e}")
        if sp.fields["mixer_launches"] != 2:
            faults.append(f"prefill at {name}'s shape launched "
                          f"{sp.fields['mixer_launches']} mixer kernels")
        at[name, l] = dict(
            shape=f"B{b}xL{l}xDc{dc}xDi{di}", ms=conv_ms + gate_ms,
            plain_ms=conv_plain + gate_plain,
            bound_ms=conv_bound + gate_bound,
            err=max(conv_chk[1], gate_chk[1]))
    log("ssm_mixer_build", instantiations=len(usage),
        max_registers=max(u_[0] for u_ in usage.values()),
        spills=json.dumps(spills).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")
    if spills:
        faults.append(f"ssm_mixer instantiations spill: {spills}")
    if faults:
        raise AssertionError("; ".join(faults))
    m2 = at["mamba2-780m", MAMBA_SEQ]
    gr = at["granite-4.0-h-small", GRANITE_SEQ]
    return dict(
        name="ssm_mixer", route="cuda",
        source="src/repro_torch/csrc/ssm_mixer.cu",
        replaces="none: src/repro/models/ssm.py _causal_conv, _out are "
                 "plain jnp",
        max_abs_err=max(v["err"] for v in at.values()),
        max_scaled_err=None, ms=m2["ms"], event_ms=None,
        plain_ms=m2["plain_ms"], bound_ms=m2["bound_ms"], bound_by="bytes",
        library_ms=None, granite_shape=gr["shape"], granite_ms=gr["ms"],
        granite_plain_ms=gr["plain_ms"], granite_bound_ms=gr["bound_ms"])


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
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.kernel import decode_attention
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
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.kernels.ssd.kernel import ssd_scan
    from repro_torch.kernels.ssm_mixer import kernel as ssm_mixer
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
    from repro_torch.telemetry import FileSink, TelemetryBus, spans

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
                               "rglru_scan", "ssd", "decode_attention",
                               "ssm_mixer")}
    # (the mixer's two kernels share one counter, a module attribute)
    KERNEL_FNS = {"era_step": era_step_fused, "noma_rate": noma_rate,
                  "flash_attention": flash_attention_bshd,
                  "ssm_mixer": ssm_mixer}
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

    log_graph_pool(dev, "phase 6")

    # ---- 7. flash_attention --------------------------------------------
    # recurrentgemma-2b's local attention: H=10, K=1, D=256, window 2048
    b, s_len, h, kh, d, win = 2, 4096, 10, 1, 256, 2048
    q, k, v = attn_inputs(dev, b, s_len, h, kh, d, torch.bfloat16,
                          SEED + 300)
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
    q, k, v = attn_inputs(dev, SERVE_USERS, SERVE_SEQ, h, kh, d,
                          torch.bfloat16,
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
    q32, k32, v32 = attn_inputs(dev, 2, 512, h, kh, d, torch.float32,
                                SEED + 301)
    _, fa_err32_s512, _, _ = attn_check(q32, k32, v32, 128, 2e-5)
    del q32, k32, v32
    # mixtral-8x22b's sliding-window attention: 48 q heads over 8 kv heads
    # (GQA group 6), D=128, window 4096 binding past it (bf16)
    mx = dict(b=2, s_len=MOE_SEQ, h=48, kh=8, d=128, win=4096)
    q, k, v = attn_inputs(dev, mx["b"], mx["s_len"], mx["h"], mx["kh"],
                          mx["d"], torch.bfloat16, SEED + 303)
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
    decode_attention.launches = 0
    decode_calls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(da_ops, "_kernel",
                           keeping_decode_calls(decode_calls)):
        t0 = time.perf_counter()
        out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    launches["flash_attention"] = flash_attention_bshd.launches
    launches["rglru_scan"] = rglru_scan.launches
    launches["decode_attention"] = decode_attention.launches
    for name in ("flash_attention", "rglru_scan", "decode_attention"):
        by_path[name]["recurrentgemma"] = launches[name]
    for name in ("flash_attention", "rglru_scan", "decode_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the model path")
    check_served(out, ids, mcfg)
    decode_checked = checked_decode_calls(decode_calls, "phase 9")
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
    # sequential scan (in place of the associative scan a non-kernel impl
    # takes), with neither kernel launched
    n_fa, n_scan = flash_attention_bshd.launches, rglru_scan.launches
    with mock.patch.object(rglru_mod, "linear_scan_associative",
                           scan_ref.linear_scan_sequential):
        plain, _ = transformer.forward(model, mcfg, rows, impl="naive")
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
                             ("flash_attention", "rglru_scan",
                              "decode_attention")}).replace(" ", ""),
        decode_attention_vs_plain=json.dumps(decode_checked
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
    ssd_shape = (SERVE_USERS, MAMBA_SEQ, 48, 64, 128)
    sargs = ssd_inputs(dev, *ssd_shape, torch.bfloat16, SEED + 900)
    chunked = lambda *a_: ssd_ref.ssd_chunked(*a_, chunk=256)
    ssd_err, ssd_scaled = ssd_check(sargs, 256, chunked, "bf16, model shape")
    y1, s1 = ssd_scan(*sargs, chunk=256)
    y2, s2 = ssd_scan(*sargs, chunk=256)
    if not (torch.equal(y1, y2) and torch.equal(s1, s2)):
        raise AssertionError("ssd kernel is not deterministic")
    del y1, s1, y2, s2
    f32_args = ssd_inputs(dev, 2, 512, 4, 64, 128, torch.float32,
                          SEED + 901)
    f32_err, f32_scaled = ssd_check(f32_args, 256, chunked, "f32")
    del f32_args
    # a ragged last chunk (2000 = 7 x 256 + 208) against the sequential
    # recurrence, in float32 at the model's heads
    rag_args = ssd_inputs(dev, 2, 2000, 48, 64, 128, torch.float32,
                          SEED + 902)
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
    ssm_mixer.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, fn in (("ssd", ssd_scan), ("ssm_mixer", ssm_mixer)):
        launches[name] = fn.launches
        by_path[name]["mamba2"] = fn.launches
        if fn.launches <= 0:
            raise AssertionError(f"{name} was not launched on the mamba2 "
                                 f"path")
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
    n_ssd, n_mixer = ssd_scan.launches, ssm_mixer.launches
    plain, _ = transformer.forward(model, mcfg, rows, impl="naive")
    plain128, _ = transformer.forward(model, mcfg.replace(ssd_chunk=128),
                                      rows, impl="naive")
    if ssd_scan.launches != n_ssd or ssm_mixer.launches != n_mixer:
        raise AssertionError("the plain forward launched the ssd or a "
                             "mixer kernel")
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
    # a round with the spans on, as a traced benchmark run has them: every
    # ``ssm`` span launched both mixer kernels once
    with spans.enable():
        spans.clear()
        n_mixer = ssm_mixer.launches
        mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
        torch.cuda.synchronize()
        span_round = ssm_mixer.launches - n_mixer
        ssm_spans = [s_.fields["mixer_launches"] for s_ in spans.finished()
                     if s_.name == "ssm"]
        spans.clear()
    if not ssm_spans or set(ssm_spans) != {2}:
        raise AssertionError(f"the mamba2 round's ssm spans launched "
                             f"{sorted(set(ssm_spans))} mixer kernels "
                             f"({len(ssm_spans)} spans), not 2 each")
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
        launches=json.dumps({n: launches[n] for n in ("ssd", "ssm_mixer")}
                            ).replace(" ", ""),
        ssm_spans=len(ssm_spans), span_mixer_launches=sorted(set(ssm_spans)),
        spanned_round_mixer_launches=span_round)
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
    decode_attention.launches = 0
    decode_calls = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(moe_mod, "slots", counted_slots), \
            mock.patch.object(da_ops, "_kernel",
                              keeping_decode_calls(decode_calls)):
        t0 = time.perf_counter()
        out = mcluster.serve_round(by_cell, decode_steps=DECODE_STEPS)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    by_path["flash_attention"]["mixtral"] = flash_attention_bshd.launches
    by_path["decode_attention"]["mixtral"] = decode_attention.launches
    for name_, fn_ in (("flash_attention", flash_attention_bshd),
                       ("decode_attention", decode_attention)):
        if fn_.launches <= 0:
            raise AssertionError(f"{name_} was not launched on the mixtral "
                                 f"path")
    check_served(out, ids, mcfg, MOE_USERS)
    decode_checked = checked_decode_calls(decode_calls, "phase 12")
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
        launches=json.dumps({n_: by_path[n_]["mixtral"] for n_ in
                             ("flash_attention", "decode_attention")}
                            ).replace(" ", ""),
        decode_attention_vs_plain=json.dumps(decode_checked
                                             ).replace(" ", ""))
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

    log_graph_pool(dev, "phase 12")

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

    log_graph_pool(dev, "phase 13")

    # ---- 14. the launcher ---------------------------------------------------
    # ``python -m repro_torch.launch.serve`` in process, on the card (no
    # --device): the async cluster with the governor, churn and a JSONL
    # trace on the tiny mixtral, then the one-cell mode on the tiny dbrx
    t_phase = time.perf_counter()
    for fn in KERNEL_FNS.values():
        fn.launches = 0
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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_sharded = serve.main(["--arch", "mixtral-8x22b", "--tiny",
                                 "--cells", "3", "--backend", "sharded"])
    sharded_out = buf.getvalue().splitlines()
    torch.cuda.synchronize()
    for name, fn in KERNEL_FNS.items():
        by_path[name]["launcher"] = fn.launches
    missing = {"bootstrap", "admission_round", "serve_round", "cell_join",
               "cell_leave"} - streams
    if rc_async != 0 or rc_one != 0 or rc_sharded != 0 or missing:
        raise AssertionError(f"the launcher exited {rc_async}, {rc_one} and "
                             f"{rc_sharded}; streams missing from its "
                             f"trace: {missing}")
    mesh_line = "sharded solver: 1-shard cells mesh on cuda:0"
    if not (any(ln.startswith("async admission: ") for ln in async_out)
            and "telemetry summary:" in async_out
            and one_out and one_out[0].startswith("served ")
            and sharded_out and sharded_out[0] == mesh_line
            and all(any(ln.startswith(f"[cell {b}] served ")
                        for ln in sharded_out) for b in range(3))):
        raise AssertionError("the launcher's summary lines are missing:\n"
                             + "\n".join(async_out + one_out + sharded_out))
    summary = async_out[async_out.index("telemetry summary:") + 1:]
    log("launcher", async_run=repr(next(ln for ln in async_out
                                        if ln.startswith("async admission"))),
        summary=repr("; ".join(" ".join(ln.split()) for ln in summary
                               if ln.startswith("  "))),
        one_cell=repr(one_out[0]),
        sharded=repr("; ".join(sharded_out[:2])),
        streams=",".join(sorted(streams)),
        launches=json.dumps({n: by_path[n]["launcher"] for n in KERNEL_FNS}
                            ).replace(" ", ""),
        phase_s=f"{time.perf_counter() - t_phase:.1f}")

    log_graph_pool(dev, "phase 14")

    # ---- 15–17. the baselines, the sharded and multihost backends --------
    phase_baselines(dev, by_path)
    sharded = phase_sharded(dev, by_path)
    phase_multihost(dev, by_path, sharded)
    # the graphs' pool after the solver phases, freed for training
    from repro_torch.core import sweep_graph
    log_graph_pool(dev, "phases 5-17")
    sweep_graph.clear_cache()
    torch.cuda.empty_cache()

    # ---- 18–19. the training path ------------------------------------------
    # it runs the plain paths, which the kernels' counts show: 0 launches
    train_fns = {"era_step": era_step_fused, "noma_rate": noma_rate,
                 "flash_attention": flash_attention_bshd,
                 "rglru_scan": rglru_scan, "ssd": ssd_scan,
                 "ssm_mixer": ssm_mixer}
    phase_training_tiny(dev, by_path, train_fns)
    phase_training_full(dev, by_path, train_fns, smi)

    # ---- 20–21. the mesh and the dry run --------------------------------
    # the plain paths again (0 launches); the dry run runs on ``meta``
    phase_mesh(dev, by_path, train_fns)
    phase_dryrun(dev, by_path, train_fns)

    # ---- 22. the compiled sweep (the GD chunk as CUDA graphs) -------------
    phase_graphed_sweep(dev, by_path)

    # ---- 23. decode attention at mixtral's decode shape --------------------
    kernels.append(phase_decode_attention(dev))

    # ---- 25. the Mamba-2 mixer's elementwise kernels ------------------------
    # (before phase 24, whose known fault would keep it out of the line)
    kernels.append(phase_ssm_mixer(dev))

    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = by_path[k["name"]]
    order = ("name", "route", "source", "replaces", "launches",
             "launches_by_path", "max_abs_err", "max_scaled_err", "ms",
             "event_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "mixtral_shape", "mixtral_ms", "mixtral_plain_ms",
             "mixtral_bound_ms", "mixtral_library_ms", "granite_shape",
             "granite_ms", "granite_plain_ms", "granite_bound_ms")
    print(json.dumps({"kernels": [{f: k[f] for f in order if f in k}
                                  for k in kernels]}))

    # ---- 24. the model kernels at granite's shapes and score scale --------
    # (after the kernels' line: its ssd check misses its bar, ROADMAP)
    phase_granite(dev)

    log("total", seconds=f"{time.perf_counter() - t_all:.1f}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
