"""Helpers the per-layer readers share: the window's rounds that the
traced stretch did not touch, and the rounds it did."""
from __future__ import annotations


def overlaps(t0, t1, marks) -> bool:
    if "trace_start" not in marks:
        return False
    return t1 > marks["trace_start"] and t0 < marks["trace_end"]


def clear(rounds, marks, start_key, end_key):
    """Rounds that ran wholly outside the traced stretch."""
    return [r for r in rounds
            if not overlaps(r[start_key], r[end_key], marks)]


def touched(rounds, marks, start_key, end_key):
    return [r for r in rounds
            if overlaps(r[start_key], r[end_key], marks)]
