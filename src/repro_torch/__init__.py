"""PyTorch / CUDA port of the ERA split-inference system (the JAX package
``repro`` is the reference it is held against).

Importing the package pins float32 matrix products to full precision:
channel gains sit around 1e-13 at path-loss exponent 5, and TF32's ten
mantissa bits would break every 1e-5 agreement bar the port is held to.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
