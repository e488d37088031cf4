"""What every traffic mix shares: the seed's streams, the dispatch from a
mix's ``kind`` to its generator, and the channel every cell observes.

A mix is a JSON file of parameters (``traffic/<mix>.json``) whose
``kind`` names its generator, ``generators/<kind>.py``; everything a
generator draws comes from ``--seed`` alone.  A new kind is a new
generator file; a mix of a kind with no generator is refused.

The channel of a cell (``channel_chain``) is the paper's §V.A network:
users uniform in the square, APs on a jittered grid, nearest-AP
association, path loss ``d^-alpha`` and Rayleigh fading (|h|^2 ~ Exp(1)),
drifting as a Gauss-Markov chain ``h' = rho h + (1 - rho) fresh
mean_m(h)`` (the program's ``evolve_scenario``, copied).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib import common

# streams drawn from one seed: each input has its own, so adding one
# never moves another
ARRIVALS, CHANNEL, TOKENS, WEIGHTS, SAMPLE = range(5)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**63 - 1), stream])


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, stream)."""
    s = int(rng(seed, stream).integers(0, 2**62))
    return torch.Generator(device=device).manual_seed(s)


def generator(mix: dict):
    """The generator module of ``mix``'s kind."""
    kind = mix["kind"]
    if not (common.BENCH / "generators" / f"{kind}.py").exists():
        raise ValueError(f"traffic kind {kind!r} has no generator "
                         f"(generators/{kind}.py)")
    return common.load_module("generators", kind)


def ap_grid(net: dict) -> np.ndarray:
    """(N, 2) AP positions: a sqrt(N) grid over [0.15, 0.85] of the side."""
    n = net["n_aps"]
    gs = int(math.ceil(math.sqrt(n)))
    lin = np.linspace(0.15, 0.85, gs)
    grid = np.stack(np.meshgrid(lin, lin), -1).reshape(-1, 2)[:n]
    return grid * net["area_m"]


def channel_chain(net: dict, n_links: int, rho: float, seed: int, cell: int,
                  device):
    """A cell's assoc (U,) and ``n_links`` successive (h_up (U, N, M),
    h_dn (N, U, M)) float32 gains, drawn on ``device`` and kept in host
    memory: a run puts on the card only the links the program holds."""
    g = device_generator(seed, CHANNEL * 1000 + cell, device)
    u, n, m = net["n_users"], net["n_aps"], net["n_subchannels"]
    users = torch.rand((u, 2), generator=g, device=device) * net["area_m"]
    aps = torch.as_tensor(ap_grid(net), dtype=torch.float32, device=device)
    d = torch.linalg.norm(users[:, None, :] - aps[None, :, :], dim=-1)
    d = torch.clamp_min(d, net["ref_distance_m"])
    path_loss = d ** (-net["path_loss_exp"])
    assoc = torch.argmin(d, dim=1)
    exp = lambda shape: torch.empty(shape, device=device).exponential_(
        generator=g)
    h_up = path_loss[:, :, None] * exp((u, n, m))
    h_dn = path_loss.T[:, :, None] * exp((n, u, m))
    links = [(h_up.cpu(), h_dn.cpu())]
    for _ in range(n_links - 1):
        h_up = rho * h_up + (1 - rho) * exp((u, n, m)) * torch.mean(
            h_up, dim=-1, keepdim=True)
        h_dn = rho * h_dn + (1 - rho) * exp((n, u, m)) * torch.mean(
            h_dn, dim=-1, keepdim=True)
        links.append((h_up.cpu(), h_dn.cpu()))
    return assoc.cpu(), links


def sample(seed: int, population: int, k: int) -> list:
    """``k`` distinct indices of ``range(population)`` drawn from the
    seed, sorted."""
    return sorted(rng(seed, SAMPLE).permutation(population)[:k].tolist())
