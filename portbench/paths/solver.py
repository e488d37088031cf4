"""Path runner ``solver``: the port's ERA admission loop, solver-only
(``SplitInferenceCluster(None, None, prof)``), driven open-loop.

Set-up: each cell's channel chain is drawn from the seed and built into
the program's Scenarios (the program derives their SIC orderings), all
kept in host memory; the cluster bootstraps (capturing the sweep's CUDA graphs for all B cells), then one
round of one cell and one of both warm the partial and the full round's
shapes; the admission thread starts.

Window: the arrivals of the mix are submitted at their due times and each
cell observes the next link of its chain every ``observe_period_s``; the
window stops issuing at ``seconds`` and closes when every arrival is
installed.  A link goes to the card when it is observed, so the card
holds only the links the program keeps, whatever the window's length.  An arrival's latency runs from its due time to the end of the
round that installed it (arrivals are drained in submission order, so the
rounds' arrival counts say which).

Check: every installed schedule of the window, judged by what it says
(its Γ and each user's latency, recomputed by the float64
reference from the benchmark's gains and deadlines); the bootstrap and one
round drawn from the seed solved again by the reference (from the uniform
start, and from the previous installed schedule, the program's own state,
which the rounds before it were judged on: ``starts`` reads that round
from both starts); no arrival left uninstalled.
"""
from __future__ import annotations

import math
import threading
import time

import numpy as np
import torch

from portbench.lib import traffic as gen
from portbench.reference import era as ref

# the traced stretch: the first whole admission round that starts after
# this many seconds of the window
TRACE_AT_S = 2.0
# a window's arrivals must be installed within this after the last is due
DRAIN_TIMEOUT_S = 120.0


class Tap:
    """The cluster's event sink: a snapshot after the bootstrap and after
    each admission round, taken on the admission thread."""

    def __init__(self, launches):
        self.cluster = None
        self.launches = launches
        # id of each Scenario handed to the program on the card -> its
        # (cell, link); read when a round ends, while the program holds it
        self.link = {}
        self.snaps = []
        self.cond = threading.Condition()
        # a traced window's stretch, opened at the end of the first round
        # after ``trace_at`` and closed at the end of the next, on this
        # (the admission) thread, which is then between rounds
        self.stretch = self.trace_at = None
        self.marks = {}

    def _trace(self):
        now = time.monotonic()
        if "trace_start" not in self.marks and now >= self.trace_at:
            self.stretch.start()
            self.marks["trace_start"] = time.monotonic()
        elif "trace_start" in self.marks and "trace_end" not in self.marks:
            self.stretch.stop()
            self.marks["trace_end"] = time.monotonic()

    def emit(self, name, **fields):
        if name not in ("bootstrap", "admission_round") or self.cluster is None:
            return
        ctl = self.cluster.controller
        rnd = ctl.rounds[-1] if name == "admission_round" else None
        n = ctl.n_cells
        snap = dict(
            kind=name,
            t_start=rnd.t_start if rnd else None,
            t_installed=rnd.t_installed if rnd else time.monotonic(),
            n_arrivals=rnd.n_arrivals if rnd else 0,
            cells=tuple(rnd.cells) if rnd else tuple(range(n)),
            launches=self.launches(),
            q=ctl.current_q(),
            links=[self.link[id(ctl.reference_scenario(b))]
                   for b in range(n)],
            schedules=self.cluster.engine.current_schedules().schedules)
        with self.cond:
            self.snaps.append(snap)
            self.cond.notify_all()
        if self.stretch is not None and rnd is not None:
            self._trace()


def setup(cfg, mix, seed, seconds, device):
    from repro_torch.core import ligd, network, profiles
    from repro_torch.kernels.era_step import kernel as era_kernel
    from repro_torch.serving.cluster import SplitInferenceCluster

    net = dict(cfg["network"])
    ncfg = network.NetworkConfig(**net)
    n_cells = cfg["n_cells"]
    n_links = 1 + int(math.floor(seconds / mix["observe_period_s"]))
    chains = [gen.channel_chain(net, n_links, mix["fading_rho"], seed, b,
                                device) for b in range(n_cells)]
    scns = [[network._with_orderings(ncfg, assoc, h_up, h_dn)
             for h_up, h_dn in links] for assoc, links in chains]
    prof = profiles.get_profile(cfg["profile"]["name"], device=device)
    spec = ligd.SolverSpec(**cfg["solver"])
    tap = Tap(lambda: era_kernel.era_step_fused.launches)
    cluster = SplitInferenceCluster(None, None, prof, spec=spec, bus=tap,
                                    default_q_s=mix["q_base_s"],
                                    device=device)
    st = dict(cfg=cfg, mix=mix, seed=seed, device=device, cluster=cluster,
              scns=scns, chains=chains, tap=tap, n_cells=n_cells,
              n_users=net["n_users"], traffic=gen.generator(mix))
    ids = st["ids"] = [cluster.add_cell(on_card(st, b, 0))
                       for b in range(n_cells)]
    tap.cluster = cluster
    cluster.start(threaded=False)
    # warm the partial round's shape (one cell) and the full round's
    q_w = st["traffic"].warmup_deadlines(mix, 1 + n_cells, seed)
    cluster.submit(ids[0], 0, float(q_w[0]))
    cluster.step()
    for b in range(n_cells):
        cluster.submit(ids[b], 1, float(q_w[1 + b]))
    cluster.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    cluster.controller.start()
    return st


def on_card(st, b, k):
    """Cell ``b``'s link ``k`` as a Scenario on the card, known to the tap."""
    scn = st["scns"][b][k].to(st["device"])
    st["tap"].link[id(scn)] = (b, k)
    return scn


def window(st, seconds, stretch=None):
    """Run the open loop; returns the window's record."""
    cluster, tap, mix = st["cluster"], st["tap"], st["mix"]
    due, cell, user, q = st["traffic"].arrivals(
        mix, st["n_cells"], st["n_users"], seconds, st["seed"])
    period = mix["observe_period_s"]
    n_obs = len(st["scns"][0]) - 1
    events = [(float(t), 0, int(c), int(u), float(qq))
              for t, c, u, qq in zip(due, cell, user, q)]
    events += [(k * period, 1, b, k, 0.0) for k in range(1, n_obs + 1)
               for b in range(st["n_cells"])]
    events.sort(key=lambda e: (e[0], e[1]))
    with tap.cond:
        n_before = len(tap.snaps)
    late = 0.0
    t0 = time.monotonic()
    if stretch is not None:
        tap.trace_at, tap.stretch = t0 + TRACE_AT_S, stretch
    for t, kind, b, u, qq in events:
        wait = t0 + t - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.monotonic() - (t0 + t))
        if kind == 0:
            cluster.submit(st["ids"][b], u, qq)
        else:
            cluster.observe(st["ids"][b], on_card(st, b, u))
    n_sub = len(due)
    deadline = time.monotonic() + DRAIN_TIMEOUT_S

    def installed():
        return sum(s["n_arrivals"] for s in tap.snaps[n_before:])

    with tap.cond:
        while installed() < n_sub and time.monotonic() < deadline:
            tap.cond.wait(timeout=1.0)
        rounds = tap.snaps[n_before:]
    t_end = time.monotonic()
    if stretch is not None:
        # the admission thread closes the stretch at a round's end; a
        # window whose rounds ended first closes it here, the loop idle
        with cluster.paused():
            tap.stretch = None
            if "trace_start" in tap.marks and "trace_end" not in tap.marks:
                stretch.stop()
                tap.marks["trace_end"] = time.monotonic()
    marks = dict(tap.marks)
    # each arrival's installing round, in submission order
    inst = np.full(n_sub, np.nan)
    cum = np.cumsum([s["n_arrivals"] for s in rounds]) if rounds else []
    pos = np.searchsorted(cum, np.arange(1, n_sub + 1), side="left")
    for i, r in enumerate(pos):
        if r < len(rounds):
            inst[i] = rounds[r]["t_installed"]
    latency = inst - (t0 + due)
    return dict(t0=t0, t_end=t_end, due=due, cell=cell, user=user, q=q,
                latency_s=latency, rounds=rounds, prev=tap.snaps[n_before - 1],
                late_s=late, marks=marks,
                errors=[repr(e) for e in cluster.errors])


def e2e(st, rec):
    lat = rec["latency_s"]
    done = lat[np.isfinite(lat)]
    out = {}
    if done.size:
        out["admission_p95_ms"] = float(np.percentile(done, 95) * 1e3)
    return out


def counts(st, rec):
    lat = rec["latency_s"]
    return int(lat.size), int(np.sum(~np.isfinite(lat)) + len(rec["errors"]))


def release(st):
    """Stop the admission thread and drop the program's state; keep what
    the check reads (the benchmark's gains and the tap's snapshots)."""
    st["cluster"].stop(drain=False)
    st["tap"].cluster = None
    for k in ("cluster", "scns"):
        st.pop(k, None)
    from repro_torch.core import sweep_graph
    sweep_graph.clear_cache()


# ---- the check -------------------------------------------------------------
def _tables(cfg):
    p = cfg["profile"]
    return ref.profile_tables(p["layers"], p["input_hw"], p["in_channels"],
                              p["result_bits"])


def _problem(st, links, rounding=None, dtype=torch.float64):
    """A reference Problem over (cell, link) pairs, on the card (from the
    benchmark's host copies of the gains)."""
    dev = st["device"]
    assoc = torch.stack([st["chains"][b][0] for b, _ in links]).to(dev)
    h_up = torch.stack([st["chains"][b][1][k][0] for b, k in links]).to(dev)
    h_dn = torch.stack([st["chains"][b][1][k][1] for b, k in links]).to(dev)
    return ref.Problem(st["cfg"]["network"], st["cfg"]["weights"],
                       _tables(st["cfg"]), assoc, h_up, h_dn, dtype=dtype,
                       rounding=rounding)


def _sched_alloc(pb, scheds):
    """The hard allocation that schedules state (B of them)."""
    dev = pb.h_up.device
    t = lambda key, dt=torch.float64: torch.as_tensor(
        np.stack([getattr(s, key) for s in scheds]), device=dev, dtype=dt)
    return pb.hard(t("subchannel_up", torch.int64),
                   t("subchannel_dn", torch.int64), t("power_up"),
                   t("power_dn"), t("compute_units"))


def claims(st, snap, cells):
    """How far the schedules of ``cells`` in a snapshot are from what the
    reference computes of their own allocation: (Γ, latency) worst
    relative gaps."""
    links = [snap["links"][b] for b in cells]
    pb = _problem(st, links)
    scheds = [snap["schedules"][b] for b in cells]
    dev = pb.h_up.device
    q = torch.as_tensor(snap["q"][list(cells)], dtype=torch.float64,
                        device=dev)
    s = torch.as_tensor(np.stack([x.split for x in scheds]),
                        dtype=torch.int64, device=dev)
    with torch.no_grad():
        out = pb.terms(s, _sched_alloc(pb, scheds), q)
    got = lambda key: torch.as_tensor(np.stack([getattr(x, key)
                                                for x in scheds]),
                                      dtype=torch.float64, device=dev)
    gam = torch.as_tensor([x.gamma for x in scheds], dtype=torch.float64,
                          device=dev)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())
    return rel(gam, out["gamma"]), rel(got("pred_latency"), out["t"])


def _picks(st, rec, sample_seed):
    """What the reference solves again: the bootstrap (from the uniform
    start) and one full round drawn from the seed (from the schedules
    installed before it, the program's own state).  (snapshot, previous
    snapshot or None) pairs."""
    n = st["n_cells"]
    picks = [(st["tap"].snaps[0], None)]
    full = [i for i, s in enumerate(rec["rounds"]) if len(s["cells"]) == n]
    if full:
        k = full[gen.sample(sample_seed, len(full), 1)[0]]
        picks.append((rec["rounds"][k],
                      rec["rounds"][k - 1] if k else rec["prev"]))
    return picks


def resolve(st, picks, rounding=None, dtype=torch.float64):
    """The reference's own solve of every cell of the picked rounds from
    their inputs, in one batch of lanes (a lane's solve does not depend on
    the lanes beside it)."""
    n = st["n_cells"]
    links = [snap["links"][b] for snap, _ in picks for b in range(n)]
    pb = _problem(st, links, rounding=rounding, dtype=dtype)
    dev = pb.h_up.device
    q = torch.as_tensor(np.concatenate([snap["q"] for snap, _ in picks]),
                        dtype=dtype, device=dev)
    x0 = pb.uniform()
    for i, (snap, prev) in enumerate(picks):
        if prev is None:
            continue
        lanes = slice(i * n, (i + 1) * n)
        warm = pb.soften(_sched_alloc(_problem(st, links[lanes]),
                                      prev["schedules"]))
        x0 = ref.Alloc(*(x.clone() for x in x0))
        for full, part in zip(x0, warm):
            full[lanes] = part.to(dtype)
    return pb.solve(q, x0, st["cfg"]["solver"])


def check(st, rec, sample_seed):
    """The numbers compared, each with its limit (``cfg["limits"]``)."""
    lim = st["cfg"]["limits"]
    g_claim = t_claim = 0.0
    for snap in rec["rounds"]:
        a, b = claims(st, snap, snap["cells"])
        g_claim, t_claim = max(g_claim, a), max(t_claim, b)
    picks = _picks(st, rec, sample_seed)
    out = resolve(st, picks)
    st["resolved"] = out
    got = np.concatenate([[s.gamma for s in snap["schedules"]]
                          for snap, _ in picks])
    missing = float(np.sum(~np.isfinite(rec["latency_s"]))
                    + len(rec["errors"]))
    return [("missing_arrivals", missing, lim["missing_arrivals"]),
            ("gamma_claim", g_claim, lim["gamma_claim"]),
            ("latency_claim", t_claim, lim["latency_claim"]),
            ("gamma_vs_resolve", _gap(got, out), lim["gamma_vs_resolve"])]


def _gap(got, out):
    return _rel(got, out["gamma"].cpu().numpy())


def _rel(got, want):
    return float(np.max(np.abs(got - want) / np.abs(want)))


def starts(st, rec, sample_seed):
    """The round ``check`` draws, solved by the reference from both starts:
    the schedules installed before it (the program's state, as ``check``
    starts) and the uniform allocation (the reference's own start).  The
    program's Γ against each solve, the two solves against each other and
    their Γ; None where the window had no full round (after ``check``)."""
    n = st["n_cells"]
    picks = _picks(st, rec, sample_seed)
    if len(picks) < 2:
        return None
    snap = picks[1][0]
    got = np.array([s.gamma for s in snap["schedules"]])
    warm = st["resolved"]["gamma"][n:2 * n].cpu().numpy()
    cold = resolve(st, [(snap, None)])["gamma"].cpu().numpy()
    return dict(program_vs_warm=_rel(got, warm),
                program_vs_cold=_rel(got, cold),
                cold_vs_warm=_rel(cold, warm),
                gamma_warm=warm.tolist(), gamma_cold=cold.tolist())


def _as_schedules(out):
    """A reference outcome laid out as the schedules the program installs."""
    from types import SimpleNamespace
    npy = lambda x: x.detach().cpu().numpy()
    a = out["alloc"]
    return [SimpleNamespace(
        split=npy(out["s"][b]), subchannel_up=npy(out["ch_up"][b]),
        subchannel_dn=npy(out["ch_dn"][b]), power_up=npy(a.p[b]),
        power_dn=npy(a.pap[b]), compute_units=npy(a.r[b]),
        pred_latency=npy(out["t"][b]), gamma=float(out["gamma"][b]))
        for b in range(out["s"].shape[0])]


def control(st, rec, sample_seed, rounding):
    """The control's readings of ``check``'s numbers: the reference in a
    lower precision (``rounding`` on float32) put in the program's place
    for the picked rounds, judged as the program is (after ``check``)."""
    n = st["n_cells"]
    picks = _picks(st, rec, sample_seed)
    low = _as_schedules(resolve(st, picks, rounding=rounding,
                                dtype=torch.float32))
    g = t = 0.0
    for i, (snap, _) in enumerate(picks):
        fake = dict(snap, schedules=low[i * n:(i + 1) * n])
        a, b = claims(st, fake, tuple(range(n)))
        g, t = max(g, a), max(t, b)
    return dict(gamma_claim=g, latency_claim=t,
                gamma_vs_resolve=_gap(np.array([x.gamma for x in low]),
                                      st["resolved"]))
