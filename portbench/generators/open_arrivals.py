"""Generator of the ``open_arrivals`` mixes: users posting a new task with
a QoE deadline, each user a Poisson process at ``rate_per_user_s``.

The count is fixed by the rate and the window (a Poisson process
conditioned on its count puts its arrivals uniformly in the window), so
every seed sends the same work in another order.  The deadline is
``q_base_s * U(q_lo, q_hi)``, as the program's load driver draws it
around the cluster's default.
"""
from __future__ import annotations

import numpy as np

from portbench.lib.traffic import ARRIVALS, rng


def arrivals(mix: dict, n_cells: int, n_users: int, seconds: float,
             seed: int):
    """Sorted (due_s, cell, user, q_s) arrays of one window: per cell
    ``round(rate * U * seconds)`` arrivals, uniform in [0, seconds)."""
    g = rng(seed, ARRIVALS)
    n = int(round(mix["rate_per_user_s"] * n_users * seconds))
    due = g.uniform(0.0, seconds, size=(n_cells, n))
    cell = np.repeat(np.arange(n_cells), n).reshape(n_cells, n)
    user = g.integers(0, n_users, size=(n_cells, n))
    q = mix["q_base_s"] * g.uniform(mix["q_lo"], mix["q_hi"],
                                    size=(n_cells, n))
    order = np.argsort(due, axis=None, kind="stable")
    flat = lambda a: a.reshape(-1)[order]
    return flat(due), flat(cell), flat(user), flat(q).astype(np.float64)


def warmup_deadlines(mix: dict, n: int, seed: int) -> np.ndarray:
    """Deadlines of the set-up's warm-up arrivals (same law)."""
    g = rng(seed, ARRIVALS + 100)
    return mix["q_base_s"] * g.uniform(mix["q_lo"], mix["q_hi"], size=n)
