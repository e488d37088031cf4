"""NOMA edge-intelligence network scenario (paper §II, §V.A) on torch.

A ``Scenario`` holds N APs, U users and M orthogonal subchannels:
Rayleigh-faded, distance-attenuated channel gains for uplink and downlink,
nearest-AP association, and the static SIC decode orderings that eqs.
(5)/(8) need (descending own-AP gain within a cell for the uplink,
ascending for the downlink).

Layouts are the JAX package's: ``h_up`` (U, N, M), ``h_dn`` (N, U, M),
orderings (M, U).  A batched scenario (``stack_scenarios``) carries a
leading cell axis B on every tensor, and its ``env`` leaves are (B,)
where a single cell's are 0-d — every function in ``core/`` reads its
numbers through ``env`` and broadcasts them with ``env_col``, so one code
path serves both.

Paper defaults (§V.A): N=5, U=1250, M=250, B=10 MHz, p_max=25 dBm,
path-loss exponent 5, noise PSD -174 dBm/Hz, 1e4 cycles/bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.launch.platform import resolve_device


class CellEnv(NamedTuple):
    """Numeric solver parameters of one cell (0-d float32 tensors), or of
    a batch of cells ((B,) tensors).  ``NetworkConfig`` fixes shapes and
    host-side logic; everything the solve computes with lives here, so
    cells with different numeric parameters share one batched solve."""
    noise_w: torch.Tensor
    subchannel_bw: torch.Tensor
    p_min_w: torch.Tensor
    p_max_w: torch.Tensor
    ap_p_min_w: torch.Tensor
    ap_p_max_w: torch.Tensor
    sic_threshold_w: torch.Tensor
    c_device_flops: torch.Tensor
    c_min_flops: torch.Tensor
    r_min: torch.Tensor
    r_max: torch.Tensor
    lambda_exponent: torch.Tensor
    cycles_per_bit: torch.Tensor
    xi_device: torch.Tensor
    xi_edge: torch.Tensor


def env_col(v, x):
    """Broadcast an env leaf (0-d or (B,)) against a tensor ``x`` whose
    leading axis is the same cell axis."""
    if not isinstance(v, torch.Tensor) or v.dim() == 0:
        return v
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


@dataclass(frozen=True)
class NetworkConfig:
    n_users: int = 1250
    n_aps: int = 5
    n_subchannels: int = 250
    area_m: float = 500.0                 # square side
    bandwidth_hz: float = 10e6            # total B (shared up/down per paper)
    noise_psd_dbm_hz: float = -174.0
    path_loss_exp: float = 5.0            # paper value
    ref_distance_m: float = 1.0
    p_min_w: float = 0.01                 # device tx power bounds
    p_max_w: float = 0.316                # 25 dBm
    ap_p_min_w: float = 0.1               # AP per-user component bounds
    ap_p_max_w: float = 2.0
    sic_threshold_w: float = 1e-13        # I_n^m decode threshold (p·|h|²)
    max_users_per_channel: int = 3        # paper: ≤3 devices per subchannel
    c_device_flops: float = 2e9           # device capability c_i
    c_min_flops: float = 2.5e10           # edge minimal resource unit c_min
    r_min: float = 1.0
    r_max: float = 64.0
    lambda_exponent: float = 0.85         # λ(r) = r^a
    cycles_per_bit: float = 1e4           # φ
    xi_device: float = 1.6e-29            # ξ: E = ξ c² f (eqs. 18/21)
    xi_edge: float = 3e-34

    @property
    def subchannel_bw(self) -> float:
        return self.bandwidth_hz / self.n_subchannels

    @property
    def noise_w(self) -> float:
        return 10 ** (self.noise_psd_dbm_hz / 10.0) * 1e-3 * self.subchannel_bw

    def env(self, device) -> CellEnv:
        """This config's numeric parameters as float32 0-d tensors."""
        return CellEnv(*(torch.tensor(float(getattr(self, f)),
                                      dtype=torch.float32, device=device)
                         for f in CellEnv._fields))


_SCN_FIELDS = ("assoc", "h_up", "h_dn", "up_order", "up_group_end",
               "dn_order", "dn_group_end")


@dataclass
class Scenario:
    """Static per-episode channel state + precomputed SIC orderings.
    Index tensors are int64, gains float32, all on one device."""
    cfg: NetworkConfig
    assoc: torch.Tensor          # (U,)  serving AP index
    h_up: torch.Tensor           # (U, N, M) uplink |h|² user->AP
    h_dn: torch.Tensor           # (N, U, M) downlink |H|² AP->user
    up_order: torch.Tensor       # (M, U) users grouped by AP, descending gain
    up_group_end: torch.Tensor   # (M, U) sorted index of the group's last
    dn_order: torch.Tensor       # (M, U) grouped by AP, ascending gain
    dn_group_end: torch.Tensor   # (M, U)
    env: CellEnv = None

    def __post_init__(self):
        if self.env is None:
            self.env = self.cfg.env(self.assoc.device)

    @property
    def n_users(self) -> int:
        return int(self.assoc.shape[-1])

    @property
    def batched(self) -> bool:
        return self.assoc.dim() == 2

    @property
    def device(self) -> torch.device:
        return self.assoc.device

    def own_gain_up(self):
        """(U, M) gain to the serving AP ((B, U, M) when batched)."""
        return _own(self.h_up, self.assoc)

    def own_gain_dn(self):
        """(U, M) downlink gain from the serving AP."""
        return _own(self.h_dn.transpose(-3, -2), self.assoc)

    def _tree_map(self, fn, *others):
        kids = [fn(getattr(self, f), *(getattr(o, f) for o in others))
                for f in _SCN_FIELDS]
        env = CellEnv(*(fn(*leaves) for leaves in
                        zip(self.env, *(o.env for o in others))))
        return Scenario(self.cfg, *kids, env=env)

    def to(self, device) -> "Scenario":
        return self._tree_map(lambda x: x.to(device))


def _own(h, assoc):
    """Gather the serving-AP row of ``h`` (..., U, N, M) -> (..., U, M)."""
    m = h.shape[-1]
    idx = assoc[..., None, None].expand(*assoc.shape, 1, m)
    return torch.gather(h, -2, idx).squeeze(-2)


def tree_map(fn, *objs):
    """Apply ``fn`` leaf-wise over tensors, NamedTuples of them, and the
    port's containers (``Scenario``, ``SplitProfile``)."""
    x = objs[0]
    if isinstance(x, torch.Tensor):
        return fn(*objs)
    if hasattr(x, "_tree_map"):
        return x._tree_map(fn, *objs[1:])
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, *parts) for parts in zip(*objs)))
    raise TypeError(f"tree_map: unsupported leaf container {type(x)!r}")


# NetworkConfig fields that fix array shapes / host-side algorithm
# structure; cells batched together must agree on these.
_STRUCT_FIELDS = ("n_users", "n_aps", "n_subchannels",
                  "max_users_per_channel")


def struct_compatible(a: NetworkConfig, b: NetworkConfig) -> bool:
    """True when two configs can share one batched solve (equal shapes)."""
    return all(getattr(a, f) == getattr(b, f) for f in _STRUCT_FIELDS)


def stack_scenarios(scns) -> Scenario:
    """Stack scenarios into one batched Scenario with a leading cell axis
    B.  Configs must be structurally compatible; numeric parameters ride
    per cell in the stacked ``env``.  The batched container's ``cfg`` is
    the first cell's and only representative."""
    scns = list(scns)
    if not scns:
        raise ValueError("need at least one scenario")
    ref = scns[0].cfg
    for s in scns[1:]:
        if not struct_compatible(s.cfg, ref):
            raise ValueError(
                "stack_scenarios needs structurally compatible "
                f"NetworkConfigs ({'/'.join(_STRUCT_FIELDS)}); "
                f"got {s.cfg} vs {ref}")
    return tree_map(lambda *xs: torch.stack(xs), *scns)


def take_cells(batched, idx):
    """Gather lanes ``idx`` (may repeat, for bucket padding) from a batched
    container along the leading cell axis."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    return tree_map(lambda x: x.index_select(0, idx.to(x.device)), batched)


def concat_cells(*batched):
    """Concatenate batched containers along the leading cell axis."""
    batched = [b for b in batched if b is not None]
    if not batched:
        raise ValueError("need at least one batched container")
    if len(batched) == 1:
        return batched[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *batched)


def envs_differ(scns) -> bool:
    """True when the cells carry different numeric network parameters."""
    scns = list(scns)
    ref = scns[0].env
    return any(float(a) != float(b)
               for s in scns[1:] for a, b in zip(ref, s.env))


def scenario_drift(a: Scenario, b: Scenario) -> float:
    """Symmetric, scale-free divergence of two scenarios' channel state:
        d(a, b) = Σ|a−b| / (½ Σ(a+b))      (gains are nonnegative)
    over the uplink+downlink gain tensors."""
    if a.h_up.shape != b.h_up.shape or a.h_dn.shape != b.h_dn.shape:
        raise ValueError("scenario_drift needs same-shape scenarios; got "
                         f"{tuple(a.h_up.shape)} vs {tuple(b.h_up.shape)}")
    num = (torch.sum(torch.abs(a.h_up - b.h_up))
           + torch.sum(torch.abs(a.h_dn - b.h_dn)))
    den = 0.5 * (torch.sum(a.h_up + b.h_up) + torch.sum(a.h_dn + b.h_dn))
    return float(num / torch.clamp_min(den, 1e-30))


def _orderings(own_gain: np.ndarray, assoc: np.ndarray, descending: bool):
    """Per-subchannel sort grouped by AP, plus end-of-group pointers."""
    u, m = own_gain.shape
    order = np.empty((m, u), np.int32)
    group_end = np.empty((m, u), np.int32)
    sign = -1.0 if descending else 1.0
    for ch in range(m):
        # lexsort: primary assoc, secondary gain
        idx = np.lexsort((sign * own_gain[:, ch], assoc))
        order[ch] = idx
        g = assoc[idx]
        # last index of each group, broadcast to members
        end = np.zeros(u, np.int32)
        last = u - 1
        for i in range(u - 1, -1, -1):
            if i < u - 1 and g[i] != g[i + 1]:
                last = i
            end[i] = last
        group_end[ch] = end
    return order, group_end


def _with_orderings(cfg, assoc, h_up, h_dn, env=None) -> Scenario:
    """Scenario from gains, deriving the SIC orderings on the host."""
    dev = h_up.device
    assoc_np = assoc.cpu().numpy()
    own_up = _own(h_up, assoc).cpu().numpy()
    own_dn = _own(h_dn.transpose(0, 1), assoc).cpu().numpy()
    up_order, up_group_end = _orderings(own_up, assoc_np, descending=True)
    dn_order, dn_group_end = _orderings(own_dn, assoc_np, descending=False)
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    return Scenario(cfg=cfg, assoc=assoc, h_up=h_up, h_dn=h_dn,
                    up_order=as_idx(up_order),
                    up_group_end=as_idx(up_group_end),
                    dn_order=as_idx(dn_order),
                    dn_group_end=as_idx(dn_group_end), env=env)


def make_scenario(generator: torch.Generator, cfg: NetworkConfig,
                  device=None) -> Scenario:
    """Scenario drawn from a (CPU) ``torch.Generator`` and moved to
    ``device`` (default: the card).  The draws are torch's, not
    ``jax.random``'s: the same seed gives a different scenario from the
    JAX package's, with the same distribution."""
    dev = resolve_device(device)
    g = generator
    users = torch.rand((cfg.n_users, 2), generator=g) * cfg.area_m
    # APs on a jittered grid for coverage
    gs = int(np.ceil(np.sqrt(cfg.n_aps)))
    grid = np.stack(np.meshgrid(np.linspace(0.15, 0.85, gs),
                                np.linspace(0.15, 0.85, gs)),
                    -1).reshape(-1, 2)[: cfg.n_aps] * cfg.area_m
    aps = torch.as_tensor(grid, dtype=torch.float32)

    d = torch.linalg.norm(users[:, None, :] - aps[None, :, :], dim=-1)
    d = torch.clamp_min(d, cfg.ref_distance_m)
    path_loss = d ** (-cfg.path_loss_exp)            # (U, N)
    assoc = torch.argmin(d, dim=1)                   # nearest-AP policy

    # iid Rayleigh fading per subchannel: |h|² ~ Exp(1) × path loss
    fade_up = torch.empty((cfg.n_users, cfg.n_aps, cfg.n_subchannels)
                          ).exponential_(generator=g)
    fade_dn = torch.empty((cfg.n_aps, cfg.n_users, cfg.n_subchannels)
                          ).exponential_(generator=g)
    h_up = path_loss[:, :, None] * fade_up
    h_dn = path_loss.T[:, :, None] * fade_dn
    return _with_orderings(cfg, assoc.to(dev), h_up.to(dev), h_dn.to(dev))


def evolve_scenario(scn: Scenario, generator: torch.Generator,
                    rho: float = 0.9) -> Scenario:
    """Gauss-Markov channel drift: fade' = ρ·fade + (1-ρ)·fresh (unit-mean
    exponential), positions/association fixed; SIC orderings recomputed."""
    if scn.batched:
        raise ValueError("evolve_scenario takes one cell, not a batch")
    dev = scn.device
    fresh_up = torch.empty(tuple(scn.h_up.shape)).exponential_(
        generator=generator).to(dev)
    fresh_dn = torch.empty(tuple(scn.h_dn.shape)).exponential_(
        generator=generator).to(dev)
    h_up = rho * scn.h_up + (1 - rho) * fresh_up * torch.mean(
        scn.h_up, dim=-1, keepdim=True)
    h_dn = rho * scn.h_dn + (1 - rho) * fresh_dn * torch.mean(
        scn.h_dn, dim=-1, keepdim=True)
    return _with_orderings(scn.cfg, scn.assoc, h_up, h_dn, env=scn.env)


def small_config(**overrides) -> NetworkConfig:
    """CPU-friendly scenario used by tests (paper scale is the default
    NetworkConfig): 40 MHz and a 200 m cell, so per-user NOMA rates land
    at ~10–30 Mbps and the split decision is non-trivial."""
    base = dict(n_users=36, n_aps=4, n_subchannels=12, area_m=200.0,
                bandwidth_hz=40e6)
    base.update(overrides)
    return NetworkConfig(**base)
