"""The benchmark's granite cell (``granite-4.0-h-small.prefill4096``) on
the CPU at a tiny width: its configuration keeps the published widths, a
sound run is correct, and each fault the timed path can have turns
``correct`` false by the check that guards it (the same runner,
reference and limits as on the card, past the harness's look for a
card)."""
import math
import sys
from pathlib import Path

import pytest
import torch

from port_bridge import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from portbench import run as bench  # noqa: E402
from portbench.lib import common  # noqa: E402

CELL = "granite-4.0-h-small.prefill4096"
SEED = 2**31 + 4242
TINY = dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=64, shared_intermediate_size=128,
            num_local_experts=8, num_experts_per_tok=3, vocab_size=512,
            mamba_n_heads=16, mamba_d_head=32, mamba_d_state=32,
            mamba_chunk_size=32, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"],
            attention_multiplier=1 / 64,
            # a shorter bootstrap solve (it still puts every user at split
            # 0, which set-up checks)
            solver={"backend": "chunked", "per_user_split": True,
                    "max_steps": 30})
MIX = {"prompt_len": 64, "decode_steps": 6, "check_requests": 8}
# the published config.json (the catalog's row), every key the file keeps
# under its own name; num_hidden_layers is the one cut
PUBLISHED = dict(
    attention_bias=False, attention_multiplier=0.0078125,
    embedding_multiplier=12, hidden_act="silu", hidden_size=4096,
    intermediate_size=768, logits_scaling=16, mamba_chunk_size=256,
    mamba_conv_bias=True, mamba_d_conv=4, mamba_d_head=64,
    mamba_d_state=128, mamba_expand=2, mamba_n_groups=1,
    mamba_n_heads=128, mamba_proj_bias=False,
    max_position_embeddings=131072, model_type="granitemoehybrid",
    normalization_function="rmsnorm", num_attention_heads=32,
    num_experts_per_tok=10, num_key_value_heads=8, num_local_experts=72,
    position_embedding_type="nope", residual_multiplier=0.22,
    rms_norm_eps=1e-05, rope_scaling=None, rope_theta=10000,
    shared_intermediate_size=1536, tie_word_embeddings=True,
    vocab_size=100352)
PERIOD = ["mamba"] * 5 + ["attention"] + ["mamba"] * 4


def _run(config=None):
    ov = {"config": dict(TINY, **(config or {})), "traffic": MIX}
    # a window of one round (seconds 0): the check reads its requests
    return bench.run_cell(CELL, SEED, 0.0, False, "cpu", overrides=ov,
                          t_started=0.0)


def _fails_by(out, name):
    assert not out["correct"]
    c = out["checks"][name]
    assert c["value"] > c["limit"], out["checks"]


def test_configuration_keeps_published_widths():
    cfg = common.config("granite-4.0-h-small")
    assert {k: cfg[k] for k in PUBLISHED} == PUBLISHED
    assert cfg["layer_types"] == PERIOD * 4
    assert cfg["num_hidden_layers"] == 20
    entry = next(c for c in common.manifest()["configs"]
                 if c["name"] == "granite-4.0-h-small")
    assert entry["reduced"] == ["num_hidden_layers", "n_users", "network"]
    assert entry["source"] == cfg["source"]
    assert cfg["network"]["n_users"] == 8
    assert cfg["limits"]["dropped_routes"] == 0
    assert cfg["limits"]["bad_requests"] == 0
    assert set(cfg["limits"]) == set(cfg["limits_why"])


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["dropped_routes"]["value"] == 0


def test_rotary_embedding_applied(monkeypatch):
    """The attention layers rotate q and k as a RoPE model would."""
    from repro_torch.models import attention
    from repro_torch.models.common import apply_rope
    monkeypatch.setattr(attention, "_rope", lambda cfg, x, positions:
                        apply_rope(x, positions, cfg.rope_theta))
    _fails_by(_run(), "mixer_output_gap")


def test_score_scale_of_a_plain_transformer(monkeypatch):
    """Scores scaled by 1/sqrt(head_dim), not the configured 1/head_dim."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_scale", lambda cfg:
                        1.0 / math.sqrt(cfg.resolved_head_dim))
    _fails_by(_run(), "mixer_output_gap")


def test_shared_expert_left_out(monkeypatch):
    from repro_torch.models import moe
    real = moe.ffn_mod.forward
    monkeypatch.setattr(moe.ffn_mod, "forward", lambda p, cfg, x:
                        torch.zeros_like(real(p, cfg, x)))
    _fails_by(_run(), "block_output_gap")


def test_residual_multiplier_left_out(monkeypatch):
    from repro_torch.models import blocks
    monkeypatch.setattr(blocks, "_residual", lambda cfg, x, y: x + y)
    _fails_by(_run(), "block_output_gap")


def _decode_fault(monkeypatch, fault):
    """A run whose decode steps go through ``fault(tokens, caches, pos,
    seen)``, which gives each step's tokens in place of the sound ones
    (``seen``: the tokens of the round's earlier steps): the model's
    decode step itself is patched, so that the check's replay of the
    served path runs the fault too."""
    from repro_torch.models import transformer as T
    real, seen = T.decode_step, []

    def step(params, cfg, tokens, pos, caches, **kw):
        if int(pos) == MIX["prompt_len"]:
            seen.clear()
        feed = fault(tokens, caches, int(pos), seen)
        seen.append(tokens)
        return real(params, cfg, feed, pos, caches, **kw)

    monkeypatch.setattr(T, "decode_step", step)
    return _run()


def test_decode_one_position_behind(monkeypatch):
    """From the second decode step on, each step fed the token one
    position behind the one it should.  A NoPE model reads positions only
    through its token stream and its caches: the mixtral cell's fault,
    the step's position index one too far, leaves its output as it was
    (``test_torch_granite.py``)."""
    out = _decode_fault(monkeypatch, lambda tokens, caches, pos, seen:
                        seen[-1] if seen else tokens)
    _fails_by(out, "served_route_flips")


def test_decode_from_a_zeroed_ssm_state(monkeypatch):
    """Decode starts from Mamba-2 states of zeros: the prompt's state
    lost at the hand-off."""
    def zeroed(tokens, caches, pos, seen):
        if not seen:
            for c in caches:
                if "state" in c:
                    c["state"].zero_()
        return tokens

    _fails_by(_decode_fault(monkeypatch, zeroed), "served_logit_gap")


def test_decode_from_a_zeroed_conv_history(monkeypatch):
    """Decode starts from Mamba-2 conv histories of zeros: the prompt's
    last conv_width - 1 inputs lost at the hand-off.  The conv reads them
    only in the first decode steps; the state carries the error on."""
    def zeroed(tokens, caches, pos, seen):
        if not seen:
            for c in caches:
                if "conv" in c:
                    c["conv"].zero_()
        return tokens

    _fails_by(_decode_fault(monkeypatch, zeroed), "served_logit_gap")


def test_cell_split_over_groups_refused(monkeypatch):
    import numpy as np
    from repro_torch.serving import scheduler
    monkeypatch.setattr(scheduler.Schedule, "groups", lambda self: {
        0: np.arange(4), 1: np.arange(4, 8)})
    with pytest.raises(RuntimeError, match="split 0"):
        _run()


def test_program_without_the_configuration_stops_at_set_up(monkeypatch):
    """A program with no such configuration (the parent of this cell)
    stops in set-up with a clear message, before any weight is drawn."""
    from repro_torch.configs import base
    monkeypatch.delitem(base._PORT_ONLY, "granite-4.0-h-small")
    with pytest.raises(RuntimeError, match="no granite-4.0-h-small"):
        _run()
