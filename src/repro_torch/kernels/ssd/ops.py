"""Model-facing entry point of the SSD scan: the kernel for CUDA tensors,
its plain chunked version for CPU ones."""
from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_scan


def ssd(x, dt, a, b, c, d, *, chunk=256):
    """The contract of the JAX package's ``kernels/ssd/ops.py::ssd``:

    x (Bt,L,H,P); dt (Bt,L,H); a (H,); b/c (Bt,L,N); d (H,).  Returns
    (y (Bt,L,H,P), final_state (Bt,H,P,N)), with chunk ``min(chunk, L)``.
    The model layout goes to the kernel as it is (x, b and c may be
    slices of one wider tensor); where the JAX wrapper moves x into the
    TPU kernel's (B,H,nc,Q,P) blocks, this kernel reads rows in place.
    Unlike the JAX wrapper, L need not be a multiple of the chunk."""
    q = min(chunk, x.shape[1])
    return ssd_scan(x, dt.float().contiguous(), a.float().contiguous(), b,
                    c, d.float().contiguous(), chunk=q)
