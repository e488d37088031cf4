"""The SSD scan's needs at one call's shape (B rows, L tokens, H heads of
P, state N, chunk Q), from the shapes alone.

Bytes: x in and y out (bf16), dt (float32), B and C (bf16), the final
state (float32), A and D.  Operations: per (row, chunk) the causal half of
C·Bᵀ; per (row, head, chunk) the causal half of the weighted sum, its
weights (an exp and a multiply), and C·S in plus the state update.
"""
BF16, F32 = 2, 4


def ssd_bytes(b: int, l: int, h: int, p: int, n: int) -> int:
    return (2 * b * l * h * p * BF16 + b * l * h * F32 + 2 * b * l * n * BF16
            + b * h * p * n * F32 + 2 * h * F32)


def ssd_ops(b: int, l: int, h: int, p: int, n: int, chunk: int) -> float:
    rows = [min(chunk, l - c0) for c0 in range(0, l, chunk)]
    pairs = sum(q * (q + 1) // 2 for q in rows)
    return float(b * (2 * n * pairs
                      + h * ((2 * p + 2) * pairs + 4 * sum(rows) * n * p)))
