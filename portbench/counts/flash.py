"""The flash-attention kernel's operations at one call's shape, from the
shapes alone: causal attention of B rows of S tokens over H query heads
of D, the scores and their weighted sum each 2·D a (query, key) pair,
over the S²/2 pairs a causal mask keeps (its S/2 diagonal pairs left
out: a bound from below).  Grouped kv heads change the bytes, not the
operations."""


def flash_ops(b: int, s: int, h: int, d: int) -> float:
    return 2.0 * b * h * d * s * s
