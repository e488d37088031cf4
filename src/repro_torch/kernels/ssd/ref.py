"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality) scan.

Semantics (per batch b, head h, head-dim p, state n):

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t  x_t^T      (S: (P, N))
    y_t = C_t · S_t + D_h * x_t

Layouts: x (Bt, L, H, P); dt (Bt, L, H); A, D (H,); B, C (Bt, L, N).
Math in float32 (float64 for float64 operands); y comes back in x's
dtype, the final state (Bt, H, P, N) in the math's type.

``ssd_chunked`` evaluates the scan with the SSD block decomposition
(intra-chunk quadratic term + inter-chunk recurrence), the algorithm the
kernel implements; ``ssd_sequential`` is the step-by-step recurrence that
checks both; ``ssd_decode_step`` is one token against a carried state
(``ssd_decode_step_`` the same with the state updated in place).
Unlike the JAX oracle, ``ssd_chunked`` takes an L that is not a multiple
of ``chunk``: the last chunk is padded with dt = 0 (and x = B = C = 0),
whose rows decay by exactly 1 and add exactly 0 to the state, so the
valid rows and the final state are those of the unpadded scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_BIG = -1e30


def _up(v):
    """v in float32, or in float64 where it already is."""
    return v.to(torch.promote_types(v.dtype, torch.float32))


def _init_state(init_state, bt, h, p, n, like):
    if init_state is None:
        return torch.zeros((bt, h, p, n), dtype=like.dtype, device=like.device)
    return init_state.to(like.dtype)


def ssd_sequential(x, dt, A, B, C, D, init_state=None):
    """Step-by-step reference. Returns y (Bt, L, H, P), final state."""
    bt, l, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (_up(v) for v in (x, dt, B, C, A))
    s = _init_state(init_state, bt, h, p, n, xf)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * Af)[:, :, None, None]       # (Bt,H,1,1)
        upd = (dtf[:, t, :, None, None] * xf[:, t, :, :, None]
               * Bf[:, t, None, None, :])                         # (Bt,H,P,N)
        s = decay * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    y = torch.stack(ys, 1) + xf * _up(D)[None, None, :, None]
    return y.to(x.dtype), s


def ssd_chunked(x, dt, A, B, C, D, chunk=64, init_state=None):
    """Chunked SSD. Same signature and semantics as ``ssd_sequential``;
    any L (a ragged last chunk is padded with dt = 0)."""
    bt, l, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    nc = -(-l // q)
    pad = nc * q - l

    def padded(v):
        v = _up(v)
        if pad:
            v = F.pad(v, (0, 0) * (v.dim() - 2) + (0, pad))
        return v

    xf = padded(x).reshape(bt, nc, q, h, p)
    dtf = padded(dt).reshape(bt, nc, q, h)
    Bf = padded(B).reshape(bt, nc, q, n)
    Cf = padded(C).reshape(bt, nc, q, n)
    Af = _up(A)

    da = dtf * Af[None, None, None, :]          # (Bt,nc,Q,H) log-decay steps
    cs = torch.cumsum(da, dim=2)                 # inclusive cumsum in chunk
    total = cs[:, :, -1, :]                      # (Bt,nc,H)
    xb = dtf[..., None] * xf                     # dt_j * x_j (Bt,nc,Q,H,P)

    # ---- intra-chunk (quadratic) term ----
    # M[h,i,j] = C_i·B_j * exp(cs_i - cs_j) for i >= j
    g = torch.einsum("bcin,bcjn->bcij", Cf, Bf)  # (Bt,nc,Q,Q)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]   # (Bt,nc,i,j,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    diff = torch.where(causal[None, None, :, :, None], diff,
                       torch.tensor(NEG_BIG, dtype=diff.dtype,
                                    device=x.device))
    m = torch.exp(diff) * g[..., None]           # (Bt,nc,i,j,H)
    del diff
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", m, xb)
    del m

    # ---- chunk-local end states ----
    decay_to_end = torch.exp(total[:, :, None, :] - cs)  # (Bt,nc,Q,H)
    s_local = torch.einsum("bcjhp,bcjn->bchpn",
                           xb * decay_to_end[..., None], Bf)

    # ---- inter-chunk recurrence over chunk states ----
    s = _init_state(init_state, bt, h, p, n, xf)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)                        # state entering chunk c
        s = torch.exp(total[:, c])[:, :, None, None] * s + s_local[:, c]
    s_prevs = torch.stack(s_prevs, 1)            # (Bt,nc,H,P,N)

    # ---- inter-chunk contribution ----
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cf, s_prevs) \
        * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).reshape(bt, nc * q, h, p)[:, :l]
    y = y + _up(x) * _up(D)[None, None, :, None]
    return y.to(x.dtype), s


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrent update.

    x (Bt, H, P); dt (Bt, H); B, C (Bt, N); state (Bt, H, P, N).
    Returns y (Bt, H, P), new state (``state`` is left as it was)."""
    state = state.to(_up(x).dtype, copy=True)
    return ssd_decode_step_(x, dt, A, B, C, D, state), state


def ssd_decode_step_(x, dt, A, B, C, D, state):
    """``ssd_decode_step`` with ``state`` (in the math's dtype) updated in
    place: the same products and sums, in the same order.  Returns y."""
    xf, dtf = _up(x), _up(dt)
    decay = torch.exp(dtf * _up(A))[:, :, None, None]
    upd = dtf[:, :, None, None] * xf[:, :, :, None] \
        * _up(B)[:, None, None, :]
    state.mul_(decay).add_(upd)
    y = torch.einsum("bhpn,bn->bhp", state, _up(C))
    y = y + xf * _up(D)[None, :, None]
    return y.to(x.dtype)
