"""The port's dispatch-level cost counter (``repro_torch.launch.hlo_cost``)
against the JAX package's HLO parser on the functions both count, and on
DTensor programs whose per-rank counts follow from their layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.launch import hlo_cost as jhlo_cost
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

META = torch.device("meta")


def _jax_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jhlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text()
                             ).flops


def test_chained_products_match_jax_scan():
    """8 chained 128×128 products: 2·8·128³ FLOPs, what JAX's parser
    reads off the scanned (while-loop) HLO."""
    n, m = 8, 128

    def f_torch(x, ws):
        for i in range(n):
            x = torch.tanh(x @ ws[i])
        return x

    def f_scan(x, ws):
        return jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]

    cost = hlo_cost.cost_of_callable(f_torch, torch.empty(m, m, device=META),
                                     torch.empty(n, m, m, device=META))
    assert cost.flops == 2.0 * n * m ** 3
    np.testing.assert_allclose(cost.flops, _jax_flops(f_scan, (m, m),
                                                      (n, m, m)), rtol=1e-6)
    # the products' outputs are materialised, tanh's are raw only
    assert cost.write_bytes == n * m * m * 4
    assert cost.write_bytes_raw == 2 * n * m * m * 4
    assert cost.coll_bytes == {}


def test_nested_loop_matches_jax_nested_scan():
    def f_torch(x, ws):
        for _ in range(3):
            for i in range(ws.shape[0]):
                x = x @ ws[i]
        return x

    def f_scan(x, ws):
        def body(x, _):
            return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0], None
        return jax.lax.scan(body, x, None, length=3)[0]

    cost = hlo_cost.cost_of_callable(f_torch, torch.empty(64, 64, device=META),
                                     torch.empty(4, 64, 64, device=META))
    assert cost.flops == 3 * 4 * 2 * 64 ** 3
    np.testing.assert_allclose(cost.flops, _jax_flops(f_scan, (64, 64),
                                                      (4, 64, 64)), rtol=1e-6)


def test_contraction_sharded_product_counts_its_all_reduce():
    """x @ w with the contraction on a 4-rank model axis, the output
    replicated: an all-reduce of the (8, 32) float32 output, and each
    rank's share of the FLOPs (JAX's ``test_collective_bytes_counted``
    bar)."""
    with dryrun.fake_world(4):
        mesh = make_host_mesh(1, 4)
        x = distribute_tensor(torch.empty(8, 64, device=META), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.empty(64, 32, device=META), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
        with hlo_cost.CostMode() as mode:
            y = (x @ w).redistribute(mesh, [Replicate(), Replicate()])
        assert tuple(y.to_local().shape) == (8, 32)
    assert mode.cost.total_coll_bytes >= 8 * 32 * 4, mode.cost.coll_bytes
    assert mode.cost.coll_bytes["all-reduce"] == 8 * 32 * 4
    assert mode.cost.flops == 2 * 8 * 32 * 64 / 4


@pytest.mark.parametrize("placements,share", [
    ((Shard(0), Shard(1)), 256),        # both output dims split
    ((Shard(0), Replicate()), 16),      # the model ranks repeat the work
])
def test_per_rank_flops_of_a_sharded_product(placements, share):
    """One rank's FLOPs on the 16×16 production mesh are the global
    2·M·N·K over the ranks that split the output, not the global count
    ``FlopCounterMode`` reports around DTensor code."""
    m, k, n = 256, 4096, 14336
    with dryrun.fake_world(256):
        mesh = make_production_mesh()
        x = distribute_tensor(torch.empty(m, k, dtype=torch.bfloat16,
                                          device=META), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(k, n, dtype=torch.bfloat16,
                                          device=META), mesh,
                              [Replicate(), placements[1]],
                              src_data_rank=None)
        with hlo_cost.CostMode() as mode:
            y = x @ w
        assert y.placements == placements
    assert mode.cost.flops == 2.0 * m * n * k / share
    assert mode.cost.coll_bytes == {}


def test_partial_placement_is_reduced_in_the_count():
    """A Partial output reduced to Replicate is one all-reduce of the
    local output."""
    with dryrun.fake_world(4):
        mesh = make_host_mesh(2, 2)
        p = DTensor.from_local(torch.empty(4, 8, device=META), mesh,
                               [Replicate(), Partial()])
        with hlo_cost.CostMode() as mode:
            p.redistribute(mesh, [Replicate(), Replicate()])
    assert mode.cost.coll_bytes == {"all-reduce": 4 * 8 * 4}


def test_peak_live_bytes():
    """The peak of live outputs: a chain keeps its input, the product
    and the activation alive at once, and releases as it goes."""
    def chain(x, ws):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x

    x = torch.empty(128, 128, device=META)
    ws = torch.empty(8, 128, 128, device=META)
    with hlo_cost.CostMode(track_memory=True) as mode:
        y = chain(x, ws)
        held = mode.live_bytes
        del y
    one = 128 * 128 * 4
    assert mode.peak_bytes == 3 * one
    assert held == one
    assert mode.live_bytes == 0
