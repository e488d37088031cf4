"""Split-serving launcher: ERA-scheduled multi-user inference round (the
port of the JAX package's ``launch/serve.py``, with the same flags and
modes, plus ``--device``: the card by default; ``--device cpu`` runs on
the host).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --tiny \
      --users 12 --seq-len 32 --decode-steps 8

Multi-cell mode (one batched Li-GD solve schedules every cell):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --tiny \
      --users 12 --cells 4

Async admission mode, now on the ``SplitInferenceCluster`` facade
(event-driven: serving keeps executing installed schedules while the
background solver thread re-schedules on simulated arrivals and drift):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --tiny --users 12 --cells 2 --async-admission --rounds 6 \
      --arrival-rate 2

Async mode always runs over a ``telemetry.TelemetryBus`` and ends with a
summary table (rounds, p99 solve ms, QoE attainment).  ``--trace PATH``
lands every event as JSONL, the spans of every admission and serving
round (``telemetry.spans``, on the ``span`` stream) among them;
``--governor`` attaches the ``QoSGovernor`` (defer low-drift cells under
pressure, prioritise failing QoE).

Cell-churn demo (mid-run join/leave with zero dropped rounds; surviving
cells' schedule carry-over is asserted):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
      --tiny --users 12 --cells 3 --async-admission --rounds 6 --churn

Solver structure flags map onto ONE ``SolverSpec``: ``--backend
reference|chunked|sharded|multihost`` picks the sweep engine,
``--gd-chunk`` its chunk length, ``--full-batch-admission`` the
``bucket='full'`` policy.  The legacy ``--sharded-solver`` spelling is an
alias for ``--backend sharded``.  The sharded backends shard the cells
over every visible card, or over one shard on ``--device`` where that is
given; ``multihost`` first joins the process group the ``REPRO_MH_*``
variables describe (``distributed.multihost``; one process: identical
to ``sharded``).

Randomness: the model's weights come from ``transformer.init`` with a
generator seeded by ``--seed``; scenarios, tokens and drift from host
generators seeded by ``(seed, index)`` at the indices the JAX launcher
folds into its key (``loadgen.driver.seeded_generator``).
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.loadgen.driver import seeded_generator


def _summarise(tag, results, q):
    lat = np.array([r.latency_s for r in results])
    print(f"{tag}served {len(results)} users | mean latency "
          f"{lat.mean()*1e3:.1f} ms | p95 {np.percentile(lat,95)*1e3:.1f} ms"
          f" | QoE violations {(lat > q).sum()}/{len(results)}")
    for r in results[:4]:
        print(f"{tag}  user {r.user}: dev {r.t_device*1e3:.2f}ms + up "
              f"{r.t_uplink*1e3:.2f}ms + edge {r.t_edge*1e3:.2f}ms + dn "
              f"{r.t_downlink*1e3:.2f}ms -> tokens {r.tokens_out[:6]}")


def build_spec(args):
    """Map launcher flags onto the SolverSpec every solve runs under."""
    from repro_torch.core.ligd import SolverSpec

    backend = args.backend
    if args.sharded_solver:                    # legacy alias
        backend = "sharded"
    if backend is None:
        backend = "chunked" if args.gd_chunk else "reference"
    return SolverSpec(
        backend=backend,
        gd_chunk=args.gd_chunk,
        max_steps=120,
        per_user_split=not args.no_per_user_split,
        bucket="full" if args.full_batch_admission else "pow2",
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--users", type=int, default=12)
    ap.add_argument("--cells", type=int, default=1,
                    help=">1 schedules all cells with one batched solve")
    ap.add_argument("--subchannels", type=int, default=6)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--qoe-ms", type=float, default=50.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-per-user-split", action="store_true")
    ap.add_argument("--async-admission", action="store_true",
                    help="serve through the SplitInferenceCluster facade: "
                         "background re-solves on arrivals/drift")
    ap.add_argument("--rounds", type=int, default=4,
                    help="serving rounds in async-admission mode")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean Poisson user arrivals per cell per round")
    ap.add_argument("--drift-rho", type=float, default=0.7,
                    help="Gauss-Markov channel memory per round")
    ap.add_argument("--drift-threshold", type=float, default=0.15,
                    help="divergence past which a cell is re-scheduled")
    ap.add_argument("--backend",
                    choices=["reference", "chunked", "sharded", "multihost"],
                    default=None,
                    help="SolverSpec backend (default: reference, or "
                         "chunked when --gd-chunk is set).  multihost "
                         "joins the torch.distributed group of the "
                         "REPRO_MH_* env vars (single-process: identical "
                         "to sharded)")
    ap.add_argument("--gd-chunk", type=int, default=0,
                    help="chunked lockstep-free GD segment length "
                         "(0 = the reference backend)")
    ap.add_argument("--sharded-solver", action="store_true",
                    help="legacy alias for --backend sharded")
    ap.add_argument("--full-batch-admission", action="store_true",
                    help="SolverSpec bucket='full': every admission round "
                         "re-solves a full-B-shaped batch")
    ap.add_argument("--qoe-half-life-s", type=float, default=None,
                    help="age idle users' QoE thresholds (doubling per "
                         "half-life); default off")
    ap.add_argument("--qoe-age-cap-s", type=float, default=1.0,
                    help="upper bound on aged thresholds, seconds")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="async mode: write every telemetry event, the "
                         "spans among them, as JSONL to PATH "
                         "(telemetry.FileSink)")
    ap.add_argument("--governor", action="store_true",
                    help="async mode: attach the QoSGovernor — defer "
                         "low-drift cells under pressure, prioritise "
                         "failing-QoE cells")
    ap.add_argument("--churn", action="store_true",
                    help="async mode: add a cell a third of the way in and "
                         "remove the first cell two thirds in, asserting "
                         "schedule carry-over + version continuity")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card; raises without one); 'cpu' runs on the "
                         "host")
    args = ap.parse_args(argv)

    spec = build_spec(args)
    if spec.backend == "multihost":
        from repro_torch.distributed import multihost
        info = multihost.initialize_from_env()
        print(f"multihost solver: process {info.process_id}/"
              f"{info.n_processes}, {info.n_local_devices} local devices")

    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.core import network, profiles
    from repro_torch.launch.platform import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (MultiCellServeEngine,
                                            SplitServeEngine)
    from repro_torch.serving.scheduler import (EraScheduler,
                                               MultiCellScheduler)

    dev = resolve_device(args.device)
    if spec.backend in ("sharded", "multihost"):
        from repro_torch.distributed import solver_mesh
        mesh = solver_mesh.cells_mesh(
            device=None if args.device is None else dev)
        spec = spec.replace(mesh=mesh)
        print(f"{spec.backend} solver: {len(mesh)}-shard cells mesh on "
              f"{','.join(map(str, mesh))}")
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    params = T.init(torch.Generator().manual_seed(args.seed), cfg, dev)

    ncfg = network.small_config(n_users=args.users,
                                n_subchannels=args.subchannels)
    prof = profiles.transformer_profile(cfg, seq=args.seq_len, device=dev)

    def gen(*index):
        return seeded_generator(args.seed, *index)

    def scenario(*index):
        return network.make_scenario(gen(*index), ncfg, dev)

    def make_tokens(g, n):
        shape = ((n, cfg.n_codebooks, args.seq_len) if cfg.n_codebooks > 1
                 else (n, args.seq_len))
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             dtype=torch.int32).numpy()

    q = np.full(args.users, args.qoe_ms / 1e3)

    if args.async_admission:
        import time

        from repro_torch.serving.cluster import SplitInferenceCluster
        from repro_torch.serving.governor import QoSGovernor
        from repro_torch.telemetry import FileSink, TelemetryBus, spans

        bus = TelemetryBus()
        sink = None
        tracing = contextlib.ExitStack()
        if args.trace:
            sink = FileSink(args.trace)
            bus.attach(sink)
            # every finished span (telemetry.spans) on the `span` stream
            tracing.enter_context(spans.enable(bus))
        governor = QoSGovernor() if args.governor else None

        cells = max(args.cells, 1)
        scns = [scenario(100 + b) for b in range(cells)]
        cluster = SplitInferenceCluster(
            params, cfg, prof, spec=spec,
            drift_threshold=args.drift_threshold,
            qoe_half_life_s=args.qoe_half_life_s,
            q_age_cap=args.qoe_age_cap_s,
            default_q_s=args.qoe_ms / 1e3,
            bus=bus, governor=governor, device=dev)
        ids = [cluster.add_cell(scn, q) for scn in scns]
        cluster.start(threaded=True)

        def fresh_tokens(tag, n=1):
            t = make_tokens(gen(tag), n * args.users)
            return t.reshape((n, args.users) + t.shape[1:])

        toks = {cid: t for cid, t in zip(ids, fresh_tokens(2, cells))}
        # warm the execute path before timing (first round compiles)
        cluster.serve_round(toks, decode_steps=args.decode_steps)

        rng = np.random.default_rng(args.seed)
        live = {cid: scn for cid, scn in zip(ids, scns)}
        churn_log = []
        add_at = args.rounds // 3
        remove_at = (2 * args.rounds) // 3
        served = 0
        rounds_executed = 0
        t0 = time.perf_counter()
        for rnd in range(args.rounds):
            if args.churn and rnd == add_at:
                scn_new = scenario(900)
                # paused(): the before/after reads and the churn op are
                # atomic vs the background admission thread, so the
                # version-continuity assertion cannot race a legitimate
                # drift re-solve
                with cluster.paused():
                    before = cluster.engine.current_schedules()
                    new_id = cluster.add_cell(scn_new, q)
                    after = cluster.engine.current_schedules()
                # zero-downtime contract: ONE version bump, surviving
                # cells' installed schedule objects carried over verbatim
                assert after.version == before.version + 1, \
                    (after.version, before.version)
                assert all(s_new is s_old for s_new, s_old
                           in zip(after.schedules, before.schedules)), \
                    "survivor schedule replaced during add_cell"
                ids.append(new_id)
                live[new_id] = scn_new
                toks[new_id] = fresh_tokens(901)[0]
                churn_log.append(f"round {rnd}: +cell {new_id} "
                                 f"(v{before.version}->v{after.version}, "
                                 "survivors carried)")
            if args.churn and rnd == remove_at and len(ids) > 1:
                victim = ids[0]
                keep_ids = ids[1:]
                with cluster.paused():
                    before = cluster.engine.current_schedules()
                    keep_scheds = [cluster.installed_schedule(c)
                                   for c in keep_ids]
                    cluster.remove_cell(victim)
                    after = cluster.engine.current_schedules()
                    carried = [cluster.installed_schedule(c)
                               for c in keep_ids]
                assert after.version == before.version + 1
                assert all(a is b for a, b in zip(carried, keep_scheds)), \
                    "survivor schedule replaced during remove_cell"
                ids.remove(victim)
                live.pop(victim)
                toks.pop(victim)
                churn_log.append(f"round {rnd}: -cell {victim} "
                                 f"(v{before.version}->v{after.version}, "
                                 "survivors carried)")
            # Poisson user arrivals posting fresh QoE deadlines
            n_arr = 0
            for cid in ids:
                for _ in range(rng.poisson(args.arrival_rate)):
                    u = int(rng.integers(args.users))
                    cluster.submit(cid, u, float(rng.uniform(0.5, 2.0)
                                                 * args.qoe_ms / 1e3))
                    n_arr += 1
            # Gauss-Markov channel drift, observed through the facade.
            # seeded by round then stable CellId: collision-free for any
            # cell count and any churn history
            drifts = []
            for cid in ids:
                live[cid] = network.evolve_scenario(
                    live[cid], gen(1000 + rnd, int(cid)),
                    rho=args.drift_rho)
                drifts.append(cluster.observe(cid, live[cid]))
            rounds_out = cluster.serve_round(
                toks, decode_steps=args.decode_steps)
            # a round counts only if every live cell actually served
            assert set(rounds_out) == set(ids) and \
                all(rounds_out[c] for c in ids), "cell dropped mid-round"
            rounds_executed += 1
            served += sum(r.tokens_out.size for results in rounds_out.values()
                          for r in results)
            print(f"[round {rnd}] cells {len(ids)} | arrivals {n_arr} | "
                  f"max drift {max(drifts):.3f} | schedule "
                  f"v{cluster.schedule_version} | admission rounds "
                  f"{len(cluster.rounds)}")
        dt = time.perf_counter() - t0
        cluster.stop()
        for line in churn_log:
            print(f"churn: {line}")
        # a failed background round would leave cells on stale schedules
        assert not cluster.errors, list(cluster.errors)
        print(f"async admission: {served} tokens in {dt:.2f}s "
              f"({served/dt:.1f} tok/s), {rounds_executed}/{args.rounds} "
              f"serving rounds, final schedule v{cluster.schedule_version}")

        # end-of-run telemetry summary, straight off the bus — the same
        # aggregates the load harness reports (README "Observability")
        def row(label, value):
            print(f"  {label:<26} {value}")

        solve = bus.summary("admission_round", "solve_wall_s")
        iters = bus.summary("admission_round", "iters")
        lag = bus.summary("swap_to_serve", "lag_s")
        att = bus.summary("qoe_attainment", "attainment")
        print("telemetry summary:")
        row("admission rounds", bus.count("admission_round"))
        if solve and solve.count:
            row("solve wall p50/p99 ms",
                f"{1e3*solve.p50:.1f} / {1e3*solve.p99:.1f}")
        if iters and iters.count:
            row("solver iters (total)", int(round(iters.mean * iters.count)))
        if lag and lag.count:
            row("swap-to-serve p99 ms", f"{1e3*lag.p99:.1f}")
        if att and att.count:
            row("QoE attainment (mean)", f"{att.mean:.3f}")
        row("serve rounds", bus.count("serve_round"))
        row("round errors", bus.count("round_error"))
        if governor is not None:
            for fld in ("n_deferred", "n_prioritised", "n_forced"):
                s = bus.summary("admission_round", fld)
                n = int(round(s.mean * s.count)) if s and s.count else 0
                row(f"governor {fld[2:]}", n)
        if sink is not None:
            tracing.close()
            bus.detach(sink)
            sink.close()
            print(f"telemetry trace -> {args.trace}")
        return 0

    if args.cells > 1:
        # scenario seeds at 100+ so they never collide with the token
        # seed (2) for any cell count
        scns = [scenario(100 + b) for b in range(args.cells)]
        sched = MultiCellScheduler(scns, prof, spec=spec)
        engine = MultiCellServeEngine(params, cfg, scns, sched)
        toks = make_tokens(gen(2), args.cells * args.users)
        toks = toks.reshape((args.cells, args.users) + toks.shape[1:])
        qs = np.tile(q, (args.cells, 1))
        rounds = engine.serve_round(toks, qs,
                                    decode_steps=args.decode_steps)
        for b, results in enumerate(rounds):
            _summarise(f"[cell {b}] ", results, q)
        return 0

    scn = scenario(1)
    if spec.backend in ("sharded", "multihost"):
        # one cell has no cell axis to shard: drop to the equivalent
        # single-device backend
        spec = spec.replace(mesh=None,
                            backend="chunked" if spec.gd_chunk
                            else "reference")
    sched = EraScheduler(scn, prof, spec=spec)
    engine = SplitServeEngine(params, cfg, scn, prof, sched)
    toks = make_tokens(gen(2), args.users)
    results = engine.serve_round(toks, q, decode_steps=args.decode_steps)
    _summarise("", results, q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
