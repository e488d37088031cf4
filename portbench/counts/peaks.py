"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit): HBM bytes/s and bf16 tensor-core FLOP/s."""
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
