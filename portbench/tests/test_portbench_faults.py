"""The comparison that decides ``correct`` fails a broken timed path: each
fault the cell can have, planted in the program underneath an otherwise
whole run (at the small sizes of ``small.py``, on the CPU, past the
harness's look for a card), turns ``correct`` false; the sound run at the
same size stays true."""
import numpy as np
import pytest

from portbench import run as bench
from portbench.tests import small

SEED = 2**31 + 777


def solver_run():
    return bench.run_cell("era-paper.arrivals", SEED, 2.0, False, "cpu",
                          overrides=small.SOLVER, t_started=0.0)


def serve_run():
    return bench.run_cell("mamba2-780m.prefill2k", SEED, 1.0, False, "cpu",
                          overrides=small.SERVE, t_started=0.0)


def test_sound_runs_are_correct():
    assert solver_run()["correct"]
    assert serve_run()["correct"]


def test_gd_step_that_returns_its_state(monkeypatch):
    from repro_torch.core import gd_loop
    monkeypatch.setattr(gd_loop, "advance",
                        lambda body, c, max_steps: c._replace(k=c.k + 1))
    out = solver_run()
    assert not out["correct"]
    assert out["checks"]["gamma_vs_resolve"]["value"] > \
        out["checks"]["gamma_vs_resolve"]["limit"]


def test_half_of_the_cells_left_unsolved(monkeypatch):
    from repro_torch.serving import scheduler as sch
    orig = sch.MultiCellScheduler.schedule

    def half(self, q, *, cells=None, **kw):
        lanes = list(range(self.n_cells)) if cells is None else list(cells)
        outs = self.last_outcomes
        if len(lanes) < 2 or len(outs) < self.n_cells \
                or any(outs[b] is None for b in lanes):
            return orig(self, q, cells=cells, **kw)
        keep = lanes[:len(lanes) // 2]
        fresh = orig(self, q, cells=keep, **kw)
        stale = [sch.build_schedule(self.scns[b], self.last_outcomes[b])
                 for b in lanes[len(keep):]]
        return fresh + stale

    monkeypatch.setattr(sch.MultiCellScheduler, "schedule", half)
    assert not solver_run()["correct"]


def test_schedule_altered_where_produced(monkeypatch):
    from repro_torch.serving import scheduler as sch
    orig = sch.build_schedule

    def altered(scn, out):
        s = orig(scn, out)
        s.split = s.split.copy()
        s.split[0] = (s.split[0] + 1) % 10
        return s

    monkeypatch.setattr(sch, "build_schedule", altered)
    out = solver_run()
    assert not out["correct"]
    assert out["checks"]["latency_claim"]["value"] > \
        out["checks"]["latency_claim"]["limit"]


def test_served_token_altered_where_produced(monkeypatch):
    from repro_torch.serving import engine
    orig = engine._continue_decode

    def altered(params, cfg, tokens, results, n_steps):
        orig(params, cfg, tokens, results, n_steps)
        for r in results.values():
            r.tokens_out = r.tokens_out.copy()
            r.tokens_out[-1] = (r.tokens_out[-1] + 1) % cfg.vocab_size

    monkeypatch.setattr(engine, "_continue_decode", altered)
    assert not serve_run()["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.serving import engine
    orig = engine._continue_decode

    def half(params, cfg, tokens, results, n_steps):
        n = tokens.shape[0] // 2
        first = {u: r for u, r in results.items() if u < n}
        orig(params, cfg, tokens[:n], first, n_steps)
        for u, r in results.items():
            if u >= n:
                r.tokens_out = np.asarray(results[u - n].tokens_out).copy()

    monkeypatch.setattr(engine, "_continue_decode", half)
    assert not serve_run()["correct"]
