"""The benchmark's mixtral cell (``mixtral-8x22b.prefill4608``) on the
CPU at a tiny width: its configuration keeps the published widths, a
sound run is correct, and each fault the timed path can have turns
``correct`` false by the check that guards it (the same runner,
reference and limits as on the card, past the harness's look for a
card)."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import run as bench  # noqa: E402
from portbench.lib import common  # noqa: E402

CELL = "mixtral-8x22b.prefill4608"
SEED = 2**31 + 4242
TINY = dict(program_config="mixtral-8x22b", n_layers=2, d_model=256,
            n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256, n_experts=4,
            top_k=2, vocab_size=512, rope_theta=1e6, norm_eps=1e-5,
            tie_embeddings=False, attention="global", capacity_factor=None,
            dtype="bfloat16")
SMALL = {"config": {"model": TINY},
         "traffic": {"prompt_len": 64, "decode_steps": 4,
                     "check_requests": 8}}
PUBLISHED = dict(d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                 d_ff=16384, n_experts=8, top_k=2, vocab_size=32768,
                 rope_theta=1e6, norm_eps=1e-5, tie_embeddings=False,
                 dtype="bfloat16", attention="global",
                 capacity_factor=None)


def _run(model=None):
    ov = {"config": {"model": dict(TINY, **(model or {}))},
          "traffic": SMALL["traffic"]}
    return bench.run_cell(CELL, SEED, 0.5, False, "cpu", overrides=ov,
                          t_started=0.0)


def test_configuration_keeps_published_widths():
    cfg = common.config("mixtral-8x22b")
    assert {k: cfg["model"][k] for k in PUBLISHED} == PUBLISHED
    assert cfg["model"]["n_layers"] == 7
    entry = next(c for c in common.manifest()["configs"]
                 if c["name"] == "mixtral-8x22b")
    assert entry["reduced"] == ["n_layers", "n_users", "network"]
    assert cfg["network"]["n_users"] == 8
    assert set(cfg["departures"]) >= {"attention", "capacity_factor"}
    assert cfg["limits"]["dropped_routes"] == 0


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["dropped_routes"]["value"] == 0


def test_capacity_dispatch_drops_routes():
    """The capacity dispatch in the dropless path's place: decode's
    8-token calls overfill experts, and the counter reads the drops."""
    out = _run(dict(capacity_factor=1.25))
    assert not out["correct"]
    assert out["checks"]["dropped_routes"]["value"] > 0


def test_expert_rows_out_of_order(monkeypatch):
    """The expert products put back on the wrong rows."""
    from repro_torch.models import moe
    grouped = moe._grouped_ffn
    monkeypatch.setattr(moe, "_grouped_ffn",
                        lambda *a: torch.flip(grouped(*a), (0,)))
    out = _run()
    assert not out["correct"]
    c = out["checks"]["block_output_gap"]
    assert c["value"] > c["limit"]


def test_decode_position_shifted(monkeypatch):
    """The engine's decode steps one position too far: plausible tokens
    (``token_logit_gap`` does not see it), but the served path run again
    through the engine puts its logits off the reference's."""
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine
    step = T.decode_step
    monkeypatch.setattr(
        engine, "_continue_decode",
        lambda params, cfg, start, results, n: _shifted(
            step, params, cfg, start, results, n))
    out = _run()
    assert not out["correct"]
    c = out["checks"]["served_logit_gap"]
    assert c["value"] > c["limit"]


def _shifted(step, params, cfg, start, results, n_steps):
    cur, caches, s = start.first, start.caches, start.shape[-1]
    outs = [cur]
    for j in range(n_steps - 1):
        logits, caches = step(params, cfg, cur, s + j + 1, caches)
        cur = torch.argmax(logits, -1)
        outs.append(cur)
    seq = torch.stack(outs, 1).cpu().numpy()
    for u, r in results.items():
        r.tokens_out = seq[u]


def test_cell_split_over_groups_refused(monkeypatch):
    """A schedule that puts a cell's users in two split groups is not the
    cell's traffic: set-up refuses it."""
    import numpy as np
    from repro_torch.serving import scheduler
    monkeypatch.setattr(scheduler.Schedule, "groups", lambda self: {
        0: np.arange(4), 1: np.arange(4, 8)})
    with pytest.raises(RuntimeError, match="split 0"):
        _run()
