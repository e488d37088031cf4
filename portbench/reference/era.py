"""Plain reference of the ERA admission solve (arXiv:2409.16537 §II–§III):
NOMA rates with SIC (eqs. 5–11), delay, energy and QoE (eqs. 12–22), the
utility Γ (eqs. 24–27), Li-GD's warm-started split sweep (Table I) with
the per-user split pick and polish, β rounding under the per-channel cap
and the SIC fallback to device-only.

Plain ``torch`` in float64 by default, written from the paper and from
nothing of the program: the SIC orderings are worked out here again from
the gains, and the in-group interference is a reverse cumulative sum over
each AP's users sorted by gain (no subtraction, so an empty suffix is
exactly 0).  ``rounding`` puts a lower precision in (the control): every
intermediate rounded to it, the arithmetic in ``dtype``.

Shapes carry a leading cell axis B: gains ``h_up`` (B, U, N, M) and
``h_dn`` (B, N, U, M), ``assoc`` (B, U), allocations (β_up, β_dn (B, U, M),
p, P, r (B, U)).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Alloc(NamedTuple):
    bu: torch.Tensor
    bd: torch.Tensor
    p: torch.Tensor
    pap: torch.Tensor
    r: torch.Tensor


def _keep(x):
    return x


def relu(x):
    """max(x, 0) whose gradient at a tie is split evenly (the convention
    the paper's JAX system differentiates its kinks with: a sum of
    interference that is exactly 0 passes half the gradient)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def profile_tables(layers: list, input_hw: int, cin: int, result_bits: float,
                   act_bits: int = 16):
    """A CNN's split tables from its conv chain ``layers`` of (cout, k,
    stride, pool): FLOPs of each layer (2·oh·ow·cout·cin·k², plus the pool's
    compares) and the bits of its output; device/edge FLOPs and uplink and
    downlink bits per split s in 0..F (s = F: device-only, nothing
    crosses)."""
    h = w = input_hw
    c = cin
    flops, out_bits = [], []
    for cout, k, stride, pool in layers:
        oh, ow = h // stride, w // stride
        fl = 2.0 * oh * ow * cout * c * k * k
        if pool:
            oh, ow = oh // 2, ow // 2
            fl += oh * ow * cout * 4
        h, w, c = oh, ow, cout
        flops.append(fl)
        out_bits.append(oh * ow * cout * act_bits)
    f = len(layers)
    dev = np.concatenate([[0.0], np.cumsum(np.asarray(flops, np.float64))])
    edge = dev[-1] - dev
    up = np.asarray([input_hw * input_hw * cin * 8.0] + out_bits, np.float64)
    up[-1] = 0.0
    dn = np.full(f + 1, float(result_bits))
    dn[-1] = 0.0
    return dict(layer_flops=np.asarray(flops), out_bits=np.asarray(out_bits),
                device_flops=dev, edge_flops=edge, uplink_bits=up,
                downlink_bits=dn)


def predecessors(uplink_bits) -> np.ndarray:
    """Table I's warm start: split s starts from the solved split j < s
    whose uplink size is nearest (the first on a tie); s = 0 starts cold."""
    w = np.asarray(uplink_bits, np.float64)
    pred = np.arange(len(w))
    for s in range(1, len(w)):
        pred[s] = int(np.argmin(np.abs(w[s] - w[:s])))
    return pred


class Problem:
    """B cells' static data: gains, association, SIC sort, tables, env."""

    def __init__(self, net: dict, weights: dict, tables: dict, assoc, h_up,
                 h_dn, dtype=torch.float64, rounding=None):
        self.dtype = dtype
        self.rnd = rounding or _keep
        self.net, self.wt = net, weights
        dev = h_up.device
        self.h_up = h_up.to(dtype)
        self.h_dn = h_dn.to(dtype)
        b, u, n, m = self.h_up.shape
        self.shape = (b, u, n, m)
        self.assoc = assoc.to(torch.int64)
        self.onehot = torch.nn.functional.one_hot(self.assoc, n).to(dtype)
        idx = self.assoc[:, :, None, None].expand(b, u, 1, m)
        self.own_up = torch.gather(self.h_up, 2, idx)[:, :, 0]
        self.own_dn = torch.gather(self.h_dn.transpose(1, 2), 2, idx)[:, :, 0]
        self.up_sort = self._group_sort(self.own_up, descending=True)
        self.dn_sort = self._group_sort(self.own_dn, descending=False)
        t = lambda k: torch.as_tensor(tables[k], dtype=dtype, device=dev)
        self.dev_fl, self.edge_fl = t("device_flops"), t("edge_flops")
        self.w_up, self.w_dn = t("uplink_bits"), t("downlink_bits")
        self.f = len(tables["layer_flops"])
        self.bw = net["bandwidth_hz"] / m
        self.noise = 10 ** (net["noise_psd_dbm_hz"] / 10.0) * 1e-3 * self.bw
        self.ranges = (1.0, 1.0, net["p_max_w"] - net["p_min_w"],
                       net["ap_p_max_w"] - net["ap_p_min_w"],
                       net["r_max"] - net["r_min"])

    def _group_sort(self, own, descending):
        """Users of each (cell, channel) laid out as (N, G) groups by AP,
        sorted by gain within a group (the SIC decode order), padded with a
        zero column at index U.  Returns (index (B, M, N*G) into U+1 users,
        each user's place (B, M, U) in that layout)."""
        b, u, n, m = self.shape
        key = own.transpose(1, 2)                                  # (B,M,U)
        order = torch.sort(key, dim=-1, descending=descending,
                           stable=True).indices
        a_sorted = torch.gather(self.assoc[:, None, :].expand(b, m, u), -1,
                                order)
        order = torch.gather(order, -1, torch.sort(a_sorted, dim=-1,
                                                   stable=True).indices)
        counts = torch.stack([torch.bincount(a, minlength=n)
                              for a in self.assoc])                # (B,N)
        g = int(counts.max())
        offs = torch.cumsum(counts, -1) - counts                   # (B,N)
        ap = torch.gather(self.assoc[:, None, :].expand(b, m, u), -1, order)
        k = torch.arange(u, device=own.device)[None, None, :] - torch.gather(
            offs[:, None, :].expand(b, m, n), -1, ap)
        slot = ap * g + k                                          # (B,M,U)
        index = torch.full((b, m, n * g), u, dtype=torch.int64,
                           device=own.device)
        index.scatter_(-1, slot, order)
        place = torch.empty_like(order).scatter_(-1, order, slot)
        return index, place, n, g

    def _suffix(self, x, sort):
        """Σ of ``x`` (B, U, M) over the same-AP users decoded after each
        user on its channel, back in (B, U, M) user order."""
        index, place, n, g = sort
        b, u, _, m = self.shape
        xt = torch.cat([x.transpose(1, 2),
                        x.new_zeros((b, m, 1))], dim=-1)          # (B,M,U+1)
        grouped = torch.gather(xt, -1, index).reshape(b, m, n, g)
        after = torch.flip(torch.cumsum(torch.flip(grouped, [-1]), -1), [-1])
        after = torch.cat([after[..., 1:], after.new_zeros((b, m, n, 1))],
                          dim=-1).reshape(b, m, n * g)
        return torch.gather(after, -1, place).transpose(1, 2)

    def rates(self, a: Alloc):
        """Uplink and downlink rates (B, U), bits/s."""
        R = self.rnd
        bp = R(a.bu * a.p[..., None])
        intra = R(self._suffix(R(bp * self.own_up), self.up_sort))
        other = 1.0 - self.onehot
        t_other = R(torch.einsum("bum,bunm,bun->bnm", bp, self.h_up, other))
        inter = torch.gather(t_other, 1, self.assoc[:, :, None].expand(
            -1, -1, t_other.shape[-1]))
        sinr_up = R(R(a.p[..., None] * self.own_up)
                    / R(relu(intra) + relu(inter) + self.noise))
        comp = R(a.bd * a.pap[..., None])
        intra_dn = R(self._suffix(comp, self.dn_sort) * self.own_dn)
        ap_power = R(torch.einsum("bun,bum->bnm", self.onehot, comp))
        cross = R(torch.einsum("bnm,bnum,bun->bum", ap_power, self.h_dn,
                               other))
        sinr_dn = R(R(a.pap[..., None] * self.own_dn)
                    / R(relu(intra_dn) + relu(cross) + self.noise))
        r_up = R(torch.sum(R(a.bu * self.bw * torch.log2(1.0 + sinr_up)), -1))
        r_dn = R(torch.sum(R(a.bd * self.bw * torch.log2(1.0 + sinr_dn)), -1))
        return r_up, r_dn

    def terms(self, s, a: Alloc, q):
        """Per-user latency t and energy e, each user's summand of Γ, Γ per
        cell, and the rates, at split vector ``s`` (B, U)."""
        R, net, w = self.rnd, self.net, self.wt
        r_up, r_dn = self.rates(a)
        one = torch.ones((), dtype=self.dtype, device=r_up.device)
        dev_fl, edge_fl = self.dev_fl[s], self.edge_fl[s]
        w_up, w_dn = self.w_up[s], self.w_dn[s]
        lam = R(a.r ** net["lambda_exponent"])
        edge_c = R(lam * net["c_min_flops"])
        up_s = R(w_up / torch.maximum(r_up, one))
        dn_s = R(w_dn / torch.maximum(r_dn, one))
        t = R(R(dev_fl / net["c_device_flops"]) + R(edge_fl / edge_c)
              + up_s + dn_s)
        e = R(R(net["xi_device"] * net["c_device_flops"] ** 2 * dev_fl)
              + R(net["xi_edge"] * edge_c ** 2 * edge_fl)
              + R(a.p * up_s) + R(a.pap * dn_s))
        ind = R(torch.sigmoid(w["qoe_a"] * (t / q - 1.0)))
        dct = R((t - q) * ind)
        lam_cost = R(lam * w["r_cost_scale"])
        per_user = R(w["w_t"] * t * w["t_scale"]
                     + w["w_q"] * (dct * w["t_scale"] + ind)
                     + w["w_r"] * (e * w["e_scale"] + lam_cost))
        gamma = R(w["w_t"] * R(t.sum(-1)) * w["t_scale"]
                  + w["w_q"] * (R(dct.sum(-1)) * w["t_scale"]
                                + R(ind.sum(-1)))
                  + w["w_r"] * (R(e.sum(-1)) * w["e_scale"]
                                + R(lam_cost.sum(-1))))
        return dict(t=t, e=e, per_user=per_user, gamma=gamma, r_up=r_up,
                    r_dn=r_dn)

    # ---- allocations ----------------------------------------------------
    def uniform(self) -> Alloc:
        b, u, _, m = self.shape
        net, dt, dev = self.net, self.dtype, self.h_up.device
        mid = lambda lo, hi: torch.full((b, u), 0.5 * (net[lo] + net[hi]),
                                        dtype=dt, device=dev)
        beta = torch.full((b, u, m), 1.0 / m, dtype=dt, device=dev)
        return Alloc(beta, beta.clone(), mid("p_min_w", "p_max_w"),
                     mid("ap_p_min_w", "ap_p_max_w"), mid("r_min", "r_max"))

    def hard(self, ch_up, ch_dn, p, pap, r) -> Alloc:
        """An allocation from hard channel picks (B, U) (-1: none)."""
        m = self.shape[3]
        oh = lambda ch: torch.nn.functional.one_hot(
            ch.clamp_min(0), m).to(self.dtype) * (ch >= 0)[..., None]
        c = lambda x: x.to(self.dtype)
        return Alloc(oh(ch_up), oh(ch_dn), c(p), c(pap), c(r))

    def soften(self, a: Alloc, eps=0.1) -> Alloc:
        m = self.shape[3]
        mix = lambda x: (1.0 - eps) * x + eps / m
        return a._replace(bu=mix(a.bu), bd=mix(a.bd))

    def clip(self, a: Alloc) -> Alloc:
        net = self.net

        def simplex(x):
            x = torch.clamp(x, 0.0, 1.0)
            return x / torch.clamp_min(x.sum(-1, keepdim=True), 1e-9)

        return Alloc(simplex(a.bu), simplex(a.bd),
                     torch.clamp(a.p, net["p_min_w"], net["p_max_w"]),
                     torch.clamp(a.pap, net["ap_p_min_w"], net["ap_p_max_w"]),
                     torch.clamp(a.r, net["r_min"], net["r_max"]))

    # ---- Li-GD ----------------------------------------------------------
    def gd(self, s, q, x0: Alloc, lr, tol, max_steps):
        """Projected GD on Γ, each variable's step scaled by its range and
        the whole step by the gradient's norm; a cell stops when |ΔΓ| <
        tol·(1+|Γ|) or ‖g‖ < tol, or at ``max_steps``.  Returns (alloc, Γ,
        steps) per cell."""
        b = q.shape[0]
        a = x0
        prev = torch.full((b,), float("inf"), dtype=self.dtype,
                          device=q.device)
        k = torch.zeros((b,), dtype=torch.int64, device=q.device)
        done = torch.zeros((b,), dtype=torch.bool, device=q.device)
        col = lambda v, x: v.reshape(v.shape + (1,) * (x.dim() - 1))
        for _ in range(max_steps):
            on = ~done & (k < max_steps)
            if not bool(on.any()):
                break
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True) for x in a]
                val = self.terms(s, Alloc(*leaves), q)["gamma"]
                grads = torch.autograd.grad(val.sum(), leaves)
            val = val.detach()
            grads = [torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                     for g in grads]
            gnorm = torch.sqrt(sum(torch.sum(g.reshape(b, -1) ** 2, -1)
                                   for g in grads))
            new = self.clip(Alloc(*(x - lr * rg * g / col(gnorm + 1e-12, g)
                                    for x, g, rg in
                                    zip(a, grads, self.ranges))))
            stop = ((torch.abs(val - prev) < tol * (1.0 + torch.abs(val)))
                    | (gnorm < tol))
            a = Alloc(*(torch.where(col(on, x), n_, x)
                        for n_, x in zip(new, a)))
            prev = torch.where(on, val, prev)
            done = torch.where(on, stop, done)
            k = k + on.to(k.dtype)
        with torch.no_grad():
            return a, self.terms(s, a, q)["gamma"], k

    def round_beta(self, beta: torch.Tensor) -> torch.Tensor:
        """One-hot β per cell: users by their strongest preference, each
        to its most preferred channel that has room under the cap of its
        AP's channel.  Returns (B, U) channel picks (-1: none had room)."""
        cap = self.net["max_users_per_channel"]
        out = []
        assoc = self.assoc.cpu().numpy()
        for bb, bm in enumerate(beta.detach().cpu().numpy()):
            pick = np.full(bm.shape[0], -1)
            counts = {}
            for i in np.argsort(-bm.max(axis=1)):
                for ch in np.argsort(-bm[i]):
                    key = (int(assoc[bb, i]), int(ch))
                    if counts.get(key, 0) < cap:
                        counts[key] = counts.get(key, 0) + 1
                        pick[i] = ch
                        break
            out.append(pick)
        return torch.as_tensor(np.stack(out), device=beta.device)

    def solve(self, q, x_init: Alloc, solver: dict):
        """Li-GD over every split with Table I's warm starts, the per-user
        split pick and polish, rounding and the SIC fallback.  Returns the
        final split (B, U), the hard allocation and its terms."""
        b = q.shape[0]
        u, f = self.shape[1], self.f
        lr, tol, steps = solver["lr"], solver["tol"], solver["max_steps"]
        pred = predecessors(self.w_up.cpu().numpy())
        slots, gammas = [None] * (f + 1), []
        full = lambda v: torch.full((b, u), v, dtype=torch.int64,
                                    device=q.device)
        for s in range(f + 1):
            x0 = x_init if pred[s] == s else slots[pred[s]]
            a, gam, _ = self.gd(full(s), q, x0, lr, tol, steps)
            slots[s] = a
            gammas.append(gam)
        s_star = torch.argmin(torch.stack(gammas, 1), dim=1)       # (B,)
        lanes = torch.arange(b, device=q.device)
        pick = lambda per_s: torch.stack(per_s, 1)[lanes, s_star]
        x_star = Alloc(*(pick([sl[i] for sl in slots]) for i in range(5)))
        with torch.no_grad():
            costs = torch.stack([self.terms(full(s), slots[s], q)["per_user"]
                                 for s in range(f + 1)], 1)        # (B,F+1,U)
        s_user = torch.argmin(costs, dim=1)
        a, _, _ = self.gd(s_user, q, x_star, lr, tol, steps)
        ch_up, ch_dn = self.round_beta(a.bu), self.round_beta(a.bd)
        hard = self.hard(ch_up, ch_dn, a.p, a.pap, a.r)
        gain = torch.gather(self.own_up, -1, ch_up.clamp_min(0)[..., None])
        feasible = a.p * gain[..., 0] > self.net["sic_threshold_w"]
        s_final = torch.where(feasible, s_user, torch.full_like(s_user, f))
        with torch.no_grad():
            out = self.terms(s_final, hard, q)
        return dict(s=s_final, ch_up=ch_up, ch_dn=ch_dn, alloc=hard, **out)
