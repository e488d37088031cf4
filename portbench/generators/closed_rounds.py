"""Generator of the ``closed_rounds`` mixes: every user of every cell
sends one request a round, ``prompt_len`` tokens drawn uniformly from the
vocabulary, greedy, with ``decode_steps`` tokens generated."""
from __future__ import annotations

import numpy as np

from portbench.lib.traffic import TOKENS, rng


def round_tokens(mix: dict, n_cells: int, n_users: int, vocab: int,
                 seed: int, round_idx: int) -> np.ndarray:
    """(B, U, S) int32 prompts of one closed-loop round."""
    g = rng(seed, TOKENS * 1000003 + round_idx)
    return g.integers(0, vocab, size=(n_cells, n_users, mix["prompt_len"]),
                      dtype=np.int32)
