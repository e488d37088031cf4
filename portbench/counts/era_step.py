"""Bytes of one ERA GD step at the paper's shapes, from the shapes alone:
each operand read once and each output written once, whatever kernels
implement the step.

era_step's operands (B cells, M channels, U users, N APs): β_up and β_dn
channel-major (B, M, U) float32; p, P, r, q and the four per-split rows
(device and edge FLOPs, uplink and downlink bits) as (B, 1, U) float32;
the env row (B, 1, 16); the gains to every AP, up and down, (B, N, M, U)
float32; the AP one-hot (B, N, U); the SIC decode rank and group id of
both directions (B, M, U) int32.  Its outputs: Γ (B,), ∂β_up and ∂β_dn
(B, M, U), ∂p, ∂P, ∂r (B, 1, U).  The step's update reads those and
writes the new allocation: β_up, β_dn (B, U, M), p, P, r (B, U).
"""
F32, I32 = 4, 4
ENV_LANES = 16


def era_step_bytes(b: int, m: int, u: int, n: int) -> int:
    operands = (2 * b * m * u * F32            # β_up, β_dn
                + 8 * b * u * F32              # p, P, r, q, 4 split rows
                + b * ENV_LANES * F32          # env row
                + 2 * b * n * m * u * F32      # gains up and down
                + b * n * u * F32              # AP one-hot
                + 4 * b * m * u * I32)         # ranks and group ids
    outputs = b * F32 + 2 * b * m * u * F32 + 3 * b * u * F32
    return operands + outputs


def gd_step_bytes(b: int, m: int, u: int, n: int) -> int:
    """era_step's bytes plus the new allocation the update writes."""
    return era_step_bytes(b, m, u, n) + (2 * b * u * m + 3 * b * u) * F32
