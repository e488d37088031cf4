"""The port's kernels' plain versions against the JAX package's oracles
(CPU), and the CUDA kernels against their plain versions (``cuda`` marker:
run on a card with ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``; elsewhere they skip from inside the
``cuda_device`` fixture).

The card's machine has no JAX, so this module imports the JAX package only
inside the ``J`` fixture, which only the CPU comparisons request."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import port_bridge as pb
from repro_torch.core import era, network, noma, profiles
from repro_torch.kernels.era_step import ops as eops
from repro_torch.kernels.era_step import ref as eref
from repro_torch.kernels.era_step.kernel import (era_step_fused,
                                                 thread_launches)
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bhsd, flash_attention_bshd)
from repro_torch.kernels.noma_rate import ops as nops
from repro_torch.kernels.noma_rate import ref as nref
from repro_torch.kernels.noma_rate.kernel import noma_rate
from repro_torch.kernels.rglru_scan import ops as sops
from repro_torch.kernels.rglru_scan import ref as sref
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref
from repro_torch.kernels.ssd.kernel import ssd_scan

SIZES = [(12, 6), (8, 4)]
# the JAX package's FLASH_CASES (tests/test_kernels.py):
# b, s, h, kh, d, window, dtype
FLASH_CASES = [
    (2, 256, 4, 2, 64, 0, "float32"),
    (1, 512, 8, 8, 128, 0, "float32"),
    (2, 256, 4, 1, 64, 128, "float32"),
    (1, 384, 6, 2, 64, 0, "float32"),
    (1, 256, 4, 2, 128, 64, "bfloat16"),
]
# recurrentgemma-2b's local attention shape (H=10, K=1, D=256) at card-test
# lengths, a window that binds, ragged S, and f32 at D=256
FLASH_CARD_CASES = FLASH_CASES + [
    (2, 512, 10, 1, 256, 128, "bfloat16"),
    (1, 300, 10, 1, 256, 64, "float32"),
    (2, 333, 4, 2, 128, 0, "bfloat16"),
]
# the JAX package's rglru sweep shapes (tests/test_online_and_rglru_kernel.py)
SCAN_CASES = [(2, 64, 128), (1, 256, 256), (3, 128, 384)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the JAX package's SSD_CASES (tests/test_kernels.py):
# bt, l, h, p, n, chunk, dtype of x (its B and C stay float32 there)
SSD_CASES = [
    (2, 128, 4, 32, 32, 32, "float32"),
    (1, 256, 8, 64, 128, 64, "float32"),
    (2, 512, 4, 64, 128, 256, "float32"),
    (1, 128, 4, 32, 64, 64, "bfloat16"),
]
# on the card: those, a ragged L (100 at chunk 32, 2000 at chunk 256),
# mamba2-780m's heads (H=48, P=64, N=128, chunk 256) in bf16, and every
# (P, N) instantiation of both paths with a ragged last chunk and a
# partial query tile (L = 300 at chunk 128)
SSD_CARD_CASES = SSD_CASES + [
    (2, 100, 4, 32, 32, 32, "float32"),
    (1, 2000, 4, 64, 128, 256, "bfloat16"),
    (2, 1024, 48, 64, 128, 256, "bfloat16"),
] + [(2, 300, 5, p, n, 128, dtype) for dtype in ("bfloat16", "float32")
     for p in (32, 64) for n in (32, 64, 128)]
# one bf16 ulp of the output (2^-7 of it) plus a small absolute term for
# float32 summation order near zero; float32 outputs within 1e-4 of scale
BF16_ULP_RTOL, BF16_ULP_ATOL = 2.0 ** -7, 1e-4


@pytest.fixture(scope="module")
def J():
    """The JAX package and the pieces of it these comparisons use."""
    import jax
    import jax.numpy as jnp
    from repro.core import era as jera
    from repro.core import network as jnet
    from repro.core import noma as jnoma
    from repro.core import profiles as jprof
    from repro.kernels.era_step import ops as jeops
    from repro.kernels.flash_attention import ref as jfref
    from repro.kernels.noma_rate import ref as jnref
    from repro.kernels.rglru_scan import ref as jsref
    from repro.kernels.ssd import ref as jssd
    return SimpleNamespace(jax=jax, jnp=jnp, era=jera, net=jnet,
                           noma=jnoma, prof=jprof, eops=jeops, nref=jnref,
                           fref=jfref, sref=jsref, ssd=jssd)


def _alloc(J, u, m, seed, lead=()):
    jax, jnp = J.jax, J.jnp
    ks = jax.random.split(jax.random.PRNGKey(100 + seed), 5)
    return J.era.Allocation(
        beta_up=jax.nn.softmax(jax.random.normal(ks[0], lead + (u, m)), -1),
        beta_dn=jax.nn.softmax(jax.random.normal(ks[1], lead + (u, m)), -1),
        p=jnp.exp(jax.random.normal(ks[2], lead + (u,)) * 0.3) * 0.1,
        p_ap=jnp.exp(jax.random.normal(ks[3], lead + (u,)) * 0.3),
        r=1.0 + jnp.exp(jax.random.normal(ks[4], lead + (u,)) * 0.2))


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"u{s[0]}m{s[1]}")
def step_case(request, J):
    """One cell's fused-step inputs on both sides, plus the JAX oracle's
    and jax.value_and_grad's answers, built once per size."""
    jax, jnp, jera, jnet, jprof, jeops = (J.jax, J.jnp, J.era, J.net,
                                          J.prof, J.eops)
    u, m = request.param
    cfg = jnet.small_config(n_users=u, n_subchannels=m)
    jscn = jnet.make_scenario(jax.random.PRNGKey(u * m), cfg)
    jp = jprof.get_profile("nin")
    ja = _alloc(J, u, m, seed=u + m)
    q = jnp.full((u,), 0.4)
    s = jnp.full((u,), 3, jnp.int32)
    jw = jera.Weights()
    aux = jeops.build_aux(jscn)
    g_ref, grad_ref = jeops.era_step_value_and_grad(jscn, jp, s, q, ja, jw,
                                                    aux=aux, impl="ref")
    g_ad, grad_ad = jax.value_and_grad(
        lambda a: jera.utility(jscn, jp, s, a, q, jw).gamma)(ja)
    ref = dict(g_ref=float(g_ref), grad_ref=grad_ref,
               g_ad=float(g_ad), grad_ad=grad_ad,
               rank=[np.asarray(x) for x in
                     (aux.up_rank, aux.up_gid, aux.dn_rank, aux.dn_gid)])
    port = dict(scn=pb.scenario(jscn), prof=pb.profile(jp),
                alloc=pb.allocation(ja), q=torch.full((u,), 0.4),
                s=torch.full((u,), 3, dtype=torch.int64), w=pb.weights(jw))
    return ref, port


def _port_step(pt):
    return eops.era_step_value_and_grad(pt["scn"], pt["prof"], pt["s"],
                                        pt["q"], pt["alloc"], pt["w"])


def test_plain_era_step_matches_jax_oracle(step_case):
    ref, pt = step_case
    gamma, grad = _port_step(pt)
    np.testing.assert_allclose(float(gamma), ref["g_ref"], rtol=1e-5)
    pb.assert_leaves_close(grad, ref["grad_ref"], atol=1e-5)


def test_plain_era_step_matches_jax_autodiff(step_case):
    ref, pt = step_case
    gamma, grad = _port_step(pt)
    np.testing.assert_allclose(float(gamma), ref["g_ad"], rtol=1e-5)
    pb.assert_leaves_close(grad, ref["grad_ad"], atol=1e-4)


def test_build_aux_rank_gid_equal_jax(step_case):
    """scatter_-derived rank/gid equal the JAX one-hot einsum's, exactly."""
    ref, pt = step_case
    aux = eops.build_aux(pt["scn"])
    for got, want in zip((aux.up_rank, aux.up_gid, aux.dn_rank, aux.dn_gid),
                         ref["rank"]):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_own_gain_from_slab_equals_scenario_own_gain(step_case):
    """The step reads each user's own-AP gain from the cross-gain slab at
    its serving AP; that equals the Scenario's own gains bit for bit."""
    _, pt = step_case
    scn = pt["scn"]
    aux = eops.build_aux(scn)
    for h_r, own in ((aux.h_up_r, scn.own_gain_up()),
                     (aux.h_dn_r, scn.own_gain_dn())):
        assert torch.equal(eref.own_gain_t(h_r, aux.onehot),
                           own.transpose(-1, -2))


def test_era_step_batched_equals_per_cell(J):
    """A leading cell axis B=4 gives each lane its single-cell answer."""
    cfg = J.net.small_config(n_users=8, n_subchannels=4)
    jscns = [J.net.make_scenario(J.jax.random.PRNGKey(40 + i), cfg)
             for i in range(4)]
    scns = [pb.scenario(s) for s in jscns]
    prof = pb.profile(J.prof.get_profile("nin"))
    ja = pb.allocation(_alloc(J, 8, 4, seed=7, lead=(4,)))
    q = torch.full((4, 8), 0.4)
    s = torch.full((4, 8), 2, dtype=torch.int64)
    w = era.Weights()
    g_b, grad_b = eops.era_step_value_and_grad(
        network.stack_scenarios(scns), prof, s, q, ja, w)
    assert g_b.shape == (4,)
    for b in range(4):
        g1, grad1 = eops.era_step_value_and_grad(
            scns[b], prof, s[b], q[b], era.Allocation(*(x[b] for x in ja)),
            w)
        np.testing.assert_allclose(float(g_b[b]), float(g1), rtol=1e-6)
        pb.assert_leaves_close([x[b] for x in grad_b], grad1, atol=1e-6)


def test_sic_mask_semantics():
    """mask[i, j] = same group AND decoded later; empty rows sum to an
    EXACT 0.0 (the relu-tie invariant the backward depends on)."""
    rank = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    gid = torch.tensor([[0, 0, 2, 2]], dtype=torch.int32)
    mask = eref._sic_mask(rank, gid)
    want = np.asarray([[[0, 1, 0, 0], [0, 0, 0, 0],
                        [0, 0, 0, 1], [0, 0, 0, 0]]], np.float32)
    np.testing.assert_array_equal(mask.numpy(), want)
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    out = eref._suffix_apply(mask, x).numpy()
    np.testing.assert_array_equal(out, [[2.0, 0.0, 4.0, 0.0]])
    # adjoint identity: <Ax, y> == <x, A^T y>
    y = torch.tensor([[0.5, -1.0, 2.0, 0.25]])
    lhs = float(torch.sum(eref._suffix_apply(mask, x) * y))
    rhs = float(torch.sum(x * eref._suffix_transpose(mask, y)))
    assert abs(lhs - rhs) < 1e-6


def test_era_step_wrapper_checks_operands():
    cfg = network.small_config(n_users=8, n_subchannels=4)
    scn = network.make_scenario(torch.Generator().manual_seed(0), cfg, "cpu")
    prof = profiles.get_profile("nin", "cpu")
    alloc = era.uniform_alloc(scn)
    ops = eops._operands(scn, prof, torch.zeros(8, dtype=torch.int64),
                         torch.full((8,), 0.4), alloc,
                         eops.build_aux(scn), era.Weights())
    ops = [x[None] for x in ops]
    before = era_step_fused.launches
    out = era_step_fused(*ops)                 # CPU: the plain version
    g, grads = eref.fused_step_math(*ops)
    torch.testing.assert_close(out[0], g, rtol=0, atol=0)
    assert era_step_fused.launches == before   # counts kernel launches only
    bad = list(ops)
    bad[14] = bad[14].to(torch.float32)           # up_rank
    with pytest.raises(ValueError, match="dtype"):
        era_step_fused(*bad)
    bad = list(ops)
    bad[1] = bad[1].transpose(-1, -2)
    with pytest.raises(ValueError, match="shape"):
        era_step_fused(*bad)
    bad[1] = ops[1].transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        era_step_fused(*bad)
    with pytest.raises(ValueError, match="operands"):
        era_step_fused(*ops[:17])


@pytest.fixture(scope="module")
def rate_case(J):
    cfg = J.net.small_config(n_users=12, n_subchannels=6)
    jscn = J.net.make_scenario(J.jax.random.PRNGKey(5), cfg)
    ja = _alloc(J, 12, 6, seed=5)
    return (J.noma.uplink_rates(jscn, ja.beta_up, ja.p),
            pb.scenario(jscn), pb.allocation(ja))


def test_plain_noma_rate_matches_jax_ref(J):
    rng = np.random.default_rng(0)
    u = 10
    contrib = rng.exponential(size=(3, u)).astype(np.float32)
    sig = rng.exponential(size=(3, u)).astype(np.float32)
    inter = rng.exponential(size=(3, u)).astype(np.float32) + 0.1
    gend = np.asarray([[3, 3, 3, 3, 6, 6, 6, 9, 9, 9]] * 3, np.int32)
    want = J.nref.noma_rate_ref(contrib, sig, gend, inter, 2.5)
    got = nref.noma_rate_ref(*(torch.as_tensor(x) for x in
                               (contrib, sig, gend, inter)), 2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_uplink_rates_kernel_matches_jax_core(rate_case):
    want, scn, alloc = rate_case
    got = nops.uplink_rates_kernel(scn, alloc.beta_up, alloc.p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # and the port's own autograd path, which the downlink keeps
    np.testing.assert_allclose(
        noma.uplink_rates(scn, alloc.beta_up, alloc.p).numpy(),
        got.numpy(), rtol=1e-5)


def test_noma_rate_wrapper_checks_operands(rate_case):
    _, scn, alloc = rate_case
    args = list(nops.sorted_operands(scn, alloc.beta_up, alloc.p))
    before = noma_rate.launches
    torch.testing.assert_close(noma_rate(*args), nref.noma_rate_ref(*args))
    assert noma_rate.launches == before
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        noma_rate(*bad)


def test_noma_rate_wrapper_checks_shared_memory_rows():
    """One block holds a channel's contrib and key rows plus the scan's
    carries: the first U past that raises, on any device."""
    from repro_torch.kernels.noma_rate import kernel as nk
    u = (nk.SMEM_LIMIT - nk.SCAN_SMEM) // 8 + 1
    ops = [torch.zeros((1, 1, u)) for _ in range(4)]
    ops[2] = torch.zeros((1, 1, u), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        noma_rate(*ops, torch.ones(1))


# ------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("u,m,b", [(12, 6, 1), (37, 9, 3), (300, 16, 2)])
def test_era_step_kernel_matches_plain(cuda_device, u, m, b):
    cfg = network.small_config(n_users=u, n_subchannels=m)
    scns = [network.make_scenario(torch.Generator().manual_seed(i), cfg,
                                  cuda_device) for i in range(b)]
    scn = network.stack_scenarios(scns)
    prof = profiles.get_profile("yolov2", cuda_device)
    alloc = era.uniform_alloc(scn, torch.Generator().manual_seed(9))
    s = torch.full((b, u), 5, dtype=torch.int64, device=cuda_device)
    q = torch.full((b, u), 0.3, device=cuda_device)
    ops = eops._operands(scn, prof, s, q, alloc, eops.build_aux(scn),
                         era.Weights())
    before = era_step_fused.launches
    out = era_step_fused(*ops)
    torch.cuda.synchronize()
    assert era_step_fused.launches == before + 1
    g, grads = eref.fused_step_math(*ops)
    torch.testing.assert_close(out[0], g, rtol=1e-5, atol=0)
    pb.assert_leaves_close([x.cpu() for x in out[1:]],
                           [x.cpu() for x in grads], atol=1e-4)
    again = era_step_fused(*ops)
    assert all(torch.equal(x, y) for x, y in zip(out, again))


def _edge_scenario(case, device):
    """The segmented scan's edge cases: ``one_group`` (N=1: one SIC group
    of all 1250 users spans every thread's run), ``singletons`` (five
    users, one per AP: every in-group sum is empty), ``ragged`` (U=77 and
    U=1000, multiples of neither 32 nor 256), ``zero_beta`` (N=1 with half
    the users off channel 0: their group-mates' suffixes are sums of exact
    zeros, where the plain version's balanced relu tie gives 0.5)."""
    u, n, m = {"one_group": (1250, 1, 8), "singletons": (5, 5, 4),
               "ragged77": (77, 4, 5), "ragged1000": (1000, 3, 6),
               "zero_beta": (300, 1, 6)}[case]
    cfg = network.small_config(n_users=u, n_aps=n, n_subchannels=m)
    scn = network.make_scenario(torch.Generator().manual_seed(u + n), cfg,
                                device)
    if case == "singletons":
        scn = network._with_orderings(cfg, torch.arange(u, device=device),
                                      scn.h_up, scn.h_dn)
    scn = network.stack_scenarios([scn])
    alloc = era.uniform_alloc(scn, torch.Generator().manual_seed(3))
    if case == "zero_beta":
        # off channel 0: the users decoded in the second half of its order,
        # in each direction
        aux = eops.build_aux(scn)
        b_up, b_dn = alloc.beta_up.clone(), alloc.beta_dn.clone()
        b_up[0, :, 0][aux.up_rank[0, 0] >= u // 2] = 0.0
        b_dn[0, :, 0][aux.dn_rank[0, 0] >= u // 2] = 0.0
        alloc = alloc._replace(beta_up=b_up, beta_dn=b_dn)
    return scn, alloc


@pytest.mark.cuda
def test_era_step_kernel_captured_in_a_cuda_graph(cuda_device):
    """One ``era_step_fused`` call captured in a CUDA graph: a replay
    equals an eager call bitwise, on the captured inputs and on new ones
    copied into the same buffers.  The call under capture launches
    nothing: the wrapper adds it to the thread's captured calls, not to
    its count, and a bare replay runs no counter (the solver's runner adds
    a replay's launches)."""
    b, u, m = 2, 300, 16
    cfg = network.small_config(n_users=u, n_subchannels=m)
    scn = network.stack_scenarios(
        [network.make_scenario(torch.Generator().manual_seed(i), cfg,
                               cuda_device) for i in range(b)])
    prof = profiles.get_profile("yolov2", cuda_device)
    s = torch.full((b, u), 5, dtype=torch.int64, device=cuda_device)
    q = torch.full((b, u), 0.3, device=cuda_device)
    aux = eops.build_aux(scn)
    allocs = [era.uniform_alloc(scn, torch.Generator().manual_seed(k))
              for k in (9, 10)]
    ops = [x.clone() for x in eops._operands(scn, prof, s, q, allocs[0],
                                             aux, era.Weights())]
    want = [tuple(x.clone() for x in era_step_fused(*eops._operands(
        scn, prof, s, q, a, aux, era.Weights()))) for a in allocs]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        era_step_fused(*ops)                       # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = era_step_fused.launches
    ran, captured = thread_launches()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        out = era_step_fused(*ops)
    assert era_step_fused.launches == before
    assert thread_launches() == (ran, captured + 1)
    for k, alloc in enumerate(allocs):
        new = eops._operands(scn, prof, s, q, alloc, aux, era.Weights())
        for dst, src in zip(ops, new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert era_step_fused.launches == before
        assert all(torch.equal(x, y) for x, y in zip(out, want[k])), k


@pytest.mark.cuda
@pytest.mark.parametrize("step_impl,adaptive,chunk", [
    ("fused", False, 1), ("fused", False, 7), ("autograd", False, 1),
    ("fused", True, 1)])
def test_graphed_sweep_equals_eager_loop(cuda_device, step_impl, adaptive,
                                         chunk):
    """``ligd._sweep_core`` graphed (the compiled sweep) against its eager
    loop on the card: iteration counts equal, Γ and every allocation leaf
    bitwise, and as many era_step launches less the capture warm-ups' (a
    chunk of 7 in a 40-step budget ends with a graph of the 5 remaining
    steps).  The autograd
    body is held at the solver's bar instead (Γ rtol 1e-5, leaves 1e-5 of
    their max): the backward of its gathers is a scatter-add that sums
    with atomics in a run-dependent order, so two eager runs differ in
    their last bits too."""
    from repro_torch.core import ligd
    cfg = network.small_config(n_users=12, n_subchannels=6)
    scns = [network.make_scenario(torch.Generator().manual_seed(50 + i), cfg,
                                  cuda_device) for i in range(4)]
    prep = ligd.prepare_batch(scns, profiles.get_profile("nin", cuda_device))
    q = torch.linspace(0.2, 0.6, 4, device=cuda_device)[:, None].expand(
        4, 12).contiguous()
    x_init = era.uniform_alloc(prep.scn_b)
    outs, launches = [], []
    for graphed in (True, False):
        ligd.SWEEP_STATS.update(warmup_launches=0)
        n0 = era_step_fused.launches
        with torch.no_grad():
            outs.append(ligd._sweep_core(
                prep.scn_b, q, x_init, prep.pred_b, 0.05, 1e-4, 40,
                era.Weights(), prep.prof_b, adaptive=adaptive,
                step_impl=step_impl, check_every=chunk, graphed=graphed))
        torch.cuda.synchronize()
        launches.append(era_step_fused.launches - n0
                        - ligd.SWEEP_STATS["warmup_launches"])
    g, e = outs
    assert torch.equal(g.iters, e.iters)
    if step_impl == "autograd":
        torch.testing.assert_close(g.gamma, e.gamma, rtol=1e-5, atol=0)
        pb.assert_leaves_close([x.cpu() for x in g.alloc],
                               [x.cpu() for x in e.alloc], atol=1e-5)
    else:
        assert torch.equal(g.gamma, e.gamma)
        assert all(torch.equal(x, y) for x, y in zip(g.alloc, e.alloc))
    assert launches[0] == launches[1]
    assert (launches[0] > 0) == (step_impl == "fused")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_group", "singletons", "ragged77",
                                  "ragged1000", "zero_beta"])
def test_era_step_kernel_segment_edges(cuda_device, case):
    """The in-group sums' segmented scan at its edges, held to the plain
    version (Γ rtol 1e-5, leaves 1e-4 of their max) with bit-identical
    repeats.  In ``zero_beta`` a wrong tie (1 or 0 where the plain version
    has 0.5) would move the zeroed users' gradients by O(1) of scale."""
    scn, alloc = _edge_scenario(case, cuda_device)
    u = scn.n_users
    prof = profiles.get_profile("yolov2", cuda_device)
    s = torch.full((1, u), 5, dtype=torch.int64, device=cuda_device)
    q = torch.full((1, u), 0.3, device=cuda_device)
    ops = eops._operands(scn, prof, s, q, alloc, eops.build_aux(scn),
                         era.Weights())
    out = era_step_fused(*ops)
    g, grads = eref.fused_step_math(*ops)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], g, rtol=1e-5, atol=0)
    pb.assert_leaves_close([x.cpu() for x in out[1:]],
                           [x.cpu() for x in grads], atol=1e-4)
    if case == "zero_beta":
        # the plain version's suffix on channel 0 holds exact zeros that
        # are sums of zeros (not empty suffixes): the tie case
        mask = eref._sic_mask(ops[14], ops[15])[0]
        intra = eref._suffix_apply(mask, (ops[0] * ops[2])[0])[0]  # β·p
        assert int(((intra == 0) & (mask[0].sum(-1) > 0)).sum()) \
            >= u // 2 - 1
    for _ in range(2):
        again = era_step_fused(*ops)
        assert all(torch.equal(x, y) for x, y in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("u,m,b", [(12, 6, 1), (300, 16, 2)])
def test_noma_rate_kernel_matches_plain(cuda_device, u, m, b):
    cfg = network.small_config(n_users=u, n_subchannels=m)
    scn = network.stack_scenarios(
        [network.make_scenario(torch.Generator().manual_seed(i), cfg,
                               cuda_device) for i in range(b)])
    alloc = era.uniform_alloc(scn, torch.Generator().manual_seed(3))
    args = nops.sorted_operands(scn, alloc.beta_up, alloc.p)
    before = noma_rate.launches
    got = noma_rate(*args)
    assert noma_rate.launches == before + 1
    want = nref.noma_rate_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 *
                               float(want.abs().max()))
    torch.testing.assert_close(
        nops.uplink_rates_kernel(scn, alloc.beta_up, alloc.p),
        noma.uplink_rates(scn, alloc.beta_up, alloc.p), rtol=1e-5, atol=0)


# ------------------------------------------------------ flash attention
def _flash_inputs(b, s, h, kh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32),
            rng.standard_normal((b, s, kh, d)).astype(np.float32))


@pytest.mark.parametrize("b,s,h,kh,d,window,dtype", FLASH_CASES)
def test_attention_ref_matches_jax_oracle(J, b, s, h, kh, d, window, dtype):
    """The plain version against the JAX oracle on the same (rounded)
    inputs; bf16 takes the same bits on both sides."""
    qkv = _flash_inputs(b, s, h, kh, d)
    jdt = getattr(J.jnp, dtype)
    want = J.fref.attention_ref(*(J.jnp.asarray(x, jdt) for x in qkv),
                                causal=True, window=window)
    got = fref.attention_ref(*(torch.as_tensor(x).to(getattr(torch, dtype))
                               for x in qkv), causal=True, window=window)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_flash_wrapper_folds_gqa_and_checks_operands():
    """On the CPU the wrapper gives the plain version in the kernel's
    (B·H, S, D) layout, q row i reading kv row i // group, and launches
    nothing; malformed operands raise."""
    b, s, h, kh, d = 2, 40, 4, 2, 64
    q, k, v = (torch.as_tensor(x) for x in _flash_inputs(b, s, h, kh, d))
    before = flash_attention_bshd.launches
    got = fops.flash_attention(q, k, v, causal=True, window=16)
    assert flash_attention_bshd.launches == before
    torch.testing.assert_close(
        got, fref.attention_ref(q, k, v, causal=True, window=16))
    fold = lambda x: x.transpose(1, 2).reshape(-1, s, d).contiguous()
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bhsd(fold(q)[..., :32].contiguous(),
                             fold(k)[..., :32].contiguous(),
                             fold(v)[..., :32].contiguous())
    with pytest.raises(ValueError, match="group"):
        flash_attention_bhsd(fold(q)[:3].contiguous(), fold(k), fold(v))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bhsd(fold(q).transpose(1, 2).contiguous()
                             .transpose(1, 2), fold(k), fold(v))
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_bhsd(fold(q).double(), fold(k).double(),
                             fold(v).double())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_bhsd(fold(q), fold(k).to(torch.bfloat16), fold(v))


def test_flash_bshd_reads_views_and_checks_strides():
    """On the CPU the model-layout wrapper takes strided views as they are
    (the plain version) and launches nothing; a head_dim that is not
    contiguous, or rows off 16-byte boundaries (the kernel copies rows 16
    bytes at a time), raise."""
    b, s, h, kh, d = 2, 24, 4, 2, 64
    rng = np.random.default_rng(3)
    qkv = torch.as_tensor(rng.standard_normal((b, s, h + 2 * kh, d)),
                          dtype=torch.float32)
    q, k, v = qkv.split([h, kh, kh], dim=2)
    before = flash_attention_bshd.launches
    got = flash_attention_bshd(q, k, v, causal=True, window=8)
    assert flash_attention_bshd.launches == before
    assert got.is_contiguous()
    torch.testing.assert_close(
        got, fref.attention_ref(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True, window=8))
    with pytest.raises(ValueError, match="head_dim is not contiguous"):
        flash_attention_bshd(torch.randn(b, s, d, h).transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bshd(torch.randn(b, s, h, d + 1)[..., :d], k, v)
    with pytest.raises(ValueError, match="4-D"):
        flash_attention_bshd(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bshd(q, k[:, :10], v)


@pytest.mark.parametrize("b,m,u", [(1, 1, 1), (2, 250, 1250), (3, 7, 77)])
def test_era_step_buffer_layout_is_aligned_and_disjoint(b, m, u):
    """The one buffer a CUDA call allocates for its outputs and scratch:
    every array starts on a 16-byte boundary and ends before the next."""
    from repro_torch.kernels.era_step import kernel as ek
    off = ek._layout(b, m, u)
    sizes = (b, b * m * u, b * m * u, 2 * b * u, b * u, 2 * b * m * u,
             2 * b * u, 4 * b * u)
    assert len(off) == len(sizes) + 1
    for i, n in enumerate(sizes):
        assert off[i] % 4 == 0 and off[i] + n <= off[i + 1]


def test_parse_ptxas_reads_registers_and_spills():
    from repro_torch.kernels import _build
    text = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Zk1' for 'sm_90a'",
        "ptxas info    : Function properties for _Zk1",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 412 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Zk2' for 'sm_90a'",
        "ptxas info    : Function properties for _Zk2",
        "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 255 registers, 412 bytes cmem[0]"])
    assert _build.parse_ptxas(text) == {"_Zk1": (168, 0, 0),
                                        "_Zk2": (255, 12, 4)}


# ------------------------------------------------------------ rglru scan
def _scan_inputs(bt, l, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.7, 0.999, (bt, l, d)).astype(np.float32),
            (rng.standard_normal((bt, l, d)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("bt,l,d", SCAN_CASES)
def test_linear_scan_matches_jax_sequential(J, bt, l, d):
    a, b = _scan_inputs(bt, l, d)
    want = np.asarray(J.sref.linear_scan_sequential(a, b))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    before = rglru_scan.launches
    got = sops.linear_scan(ta, tb)
    assert rglru_scan.launches == before
    for h in (got, sref.linear_scan_associative(ta, tb)):
        np.testing.assert_allclose(h.numpy() / np.abs(want).max(),
                                   want / np.abs(want).max(), atol=1e-5)
    np.testing.assert_array_equal(
        sref.linear_scan_sequential(ta, tb, h0=torch.zeros(bt, d)).numpy(),
        got.numpy())


def test_rglru_wrapper_checks_operands():
    a, b = (torch.as_tensor(x) for x in _scan_inputs(2, 8, 16))
    with pytest.raises(ValueError, match="dtype"):
        rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, b[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="B, L, D"):
        rglru_scan(a[0], b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d,window,dtype", FLASH_CARD_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, s, h, kh, d,
                                              window, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(x).to(cuda_device, dt)
               for x in _flash_inputs(b, s, h, kh, d, seed=s))
    before = flash_attention_bshd.launches
    got = fops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = fref.attention_ref(q, k, v, causal=True, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the bf16 tensor-core kernel's tile edges (128 query rows, 64 keys):
# S = 1, 77, 1000; windows 16, 100, 2048 (inside, across, beyond a tile);
# GQA groups 1, 2, 6 (mixtral-8x22b's 48 over 8), 8; D = 64, 128, 256.
# b, s, h, kh, d, window
FLASH_EDGE_CASES = [
    (1, 1, 8, 1, 256, 2048),
    (2, 77, 4, 2, 64, 16),
    (1, 77, 2, 2, 128, 100),
    (1, 1000, 2, 2, 128, 16),
    (2, 1000, 8, 1, 256, 100),
    (1, 1000, 4, 2, 64, 2048),
    (1, 1000, 8, 1, 256, 0),
    (1, 300, 8, 8, 256, 2048),
    (1, 1000, 12, 2, 128, 300),
    (2, 600, 48, 8, 128, 256),
]


def _flash_vs_plain(q, k, v, window):
    """The kernel (model layout) against its plain version in q's dtype at
    FLASH_TOL and, for bf16, against the float32 plain version within one
    bf16 ulp of the output."""
    before = flash_attention_bshd.launches
    got = fops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bshd.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = fref.attention_ref(q, k, v, causal=True, window=window)
    tol = FLASH_TOL[str(q.dtype).split(".")[1]]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    if q.dtype == torch.bfloat16:
        want32 = fref.attention_ref(q.float(), k.float(), v.float(),
                                    causal=True, window=window)
        err = (got.float() - want32).abs()
        assert bool((err <= BF16_ULP_ATOL
                     + BF16_ULP_RTOL * want32.abs()).all()), float(err.max())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kh,d,window", FLASH_EDGE_CASES)
def test_flash_attention_kernel_tile_edges(cuda_device, b, s, h, kh, d,
                                           window):
    q, k, v = (torch.as_tensor(x).to(cuda_device, torch.bfloat16)
               for x in _flash_inputs(b, s, h, kh, d, seed=s + d))
    _flash_vs_plain(q, k, v, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_kernel_reads_strided_views(cuda_device, dtype):
    """q, k and v as slices of one fused (B, S, H + 2K, D) projection: the
    kernel reads them in place and equals its result on contiguous
    copies bit for bit."""
    b, s, h, kh, d = 2, 200, 4, 2, 128
    rng = np.random.default_rng(7)
    qkv = torch.as_tensor(rng.standard_normal((b, s, h + 2 * kh, d)),
                          dtype=getattr(torch, dtype), device=cuda_device)
    q, k, v = qkv.split([h, kh, kh], dim=2)
    assert not q.is_contiguous()
    got = _flash_vs_plain(q, k, v, 64)
    dense = fops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True, window=64)
    assert torch.equal(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,d",
                         SCAN_CASES + [(16, 512, 2560), (2, 37, 300)])
def test_rglru_scan_kernel_matches_plain(cuda_device, bt, l, d):
    a, b = (torch.as_tensor(x).to(cuda_device)
            for x in _scan_inputs(bt, l, d, seed=l))
    before = rglru_scan.launches
    got = sops.linear_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    want = sref.linear_scan_sequential(a, b)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ------------------------------------------------------------------ ssd
def _ssd_inputs(bt, l, h, p, n, seed=0):
    """x, dt, a, b, c, d as float32 numpy arrays: dt from a softplus, A
    negative, D = 1 (the JAX package's sweep inputs, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bt, l, h, p)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((bt, l, h)), 0.0) * 0.1
          ).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    b = (rng.standard_normal((bt, l, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bt, l, n)) * 0.3).astype(np.float32)
    return x, dt, a, b, c, np.ones(h, np.float32)


def _ssd_bar(got, want, dtype, what):
    """float32: within 1e-5 of max |want|; bfloat16 outputs: within one
    bf16 ulp of max |want| (the math is float32 on both sides, only the
    output rounds)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    bar = 1e-5 if dtype == "float32" else BF16_ULP_RTOL
    err = np.abs(got - want).max() / scale
    assert err <= bar, f"{what}: {err:.3e} of scale > {bar}"


@pytest.mark.parametrize("bt,l,h,p,n,chunk,dtype", SSD_CASES)
def test_ssd_ref_matches_jax_oracle(J, bt, l, h, p, n, chunk, dtype):
    """The plain sequential, chunked and decode versions against the JAX
    oracles on the same inputs (x in ``dtype``, the same bits on both
    sides)."""
    x, dt, a, b, c, d = _ssd_inputs(bt, l, h, p, n)
    jx = J.jnp.asarray(x, getattr(J.jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    targs = [torch.as_tensor(v) for v in (dt, a, b, c, d)]
    jy_seq, js_seq = J.ssd.ssd_sequential(jx, dt, a, b, c, d)
    jy_ch, js_ch = J.ssd.ssd_chunked(jx, dt, a, b, c, d, chunk=chunk)
    y_seq, s_seq = ssd_ref.ssd_sequential(tx, *targs)
    y_ch, s_ch = ssd_ref.ssd_chunked(tx, *targs, chunk=chunk)
    assert y_ch.dtype == tx.dtype and s_ch.dtype == torch.float32
    for got, want, what in ((y_seq, jy_seq, "sequential y"),
                            (y_ch, jy_ch, "chunked y")):
        _ssd_bar(got.float().numpy(), np.asarray(want, np.float32), dtype,
                 what)
    for got, want, what in ((s_seq, js_seq, "sequential state"),
                            (s_ch, js_ch, "chunked state")):
        _ssd_bar(got.numpy(), np.asarray(want), "float32", what)
    # one decode step from the chunked final state
    rng = np.random.default_rng(1)
    xt = rng.standard_normal((bt, h, p)).astype(np.float32)
    jyd, jsd = J.ssd.ssd_decode_step(
        J.jnp.asarray(xt, getattr(J.jnp, dtype)), dt[:, 0], a, b[:, 0],
        c[:, 0], d, js_ch)
    yd, sd = ssd_ref.ssd_decode_step(
        torch.as_tensor(xt).to(getattr(torch, dtype)), targs[0][:, 0],
        targs[1], targs[2][:, 0], targs[3][:, 0], targs[4], s_ch)
    _ssd_bar(yd.float().numpy(), np.asarray(jyd, np.float32), dtype,
             "decode y")
    _ssd_bar(sd.numpy(), np.asarray(jsd), "float32", "decode state")


def test_ssd_chunked_ragged_matches_jax_sequential(J):
    """L = 100 at chunk 32: the last chunk is padded with dt = 0, so the
    valid rows and the final state are the unpadded scan's."""
    x, dt, a, b, c, d = _ssd_inputs(2, 100, 4, 32, 32, seed=3)
    jy, js = J.ssd.ssd_sequential(x, dt, a, b, c, d)
    y, s = ssd_ref.ssd_chunked(*(torch.as_tensor(v)
                                 for v in (x, dt, a, b, c, d)), chunk=32)
    assert y.shape == (2, 100, 4, 32)
    _ssd_bar(y.numpy(), np.asarray(jy), "float32", "ragged y")
    _ssd_bar(s.numpy(), np.asarray(js), "float32", "ragged state")
    # and the wrapper's CPU dispatch is that plain version, launching
    # nothing
    before = ssd_scan.launches
    yw, sw = ssd_ops.ssd(*(torch.as_tensor(v) for v in (x, dt, a, b, c, d)),
                         chunk=32)
    assert ssd_scan.launches == before
    assert torch.equal(yw, y) and torch.equal(sw, s)


def test_ssd_wrapper_checks_operands():
    x, dt, a, b, c, d = (torch.as_tensor(v)
                         for v in _ssd_inputs(2, 40, 4, 32, 32))
    # the model's layout: x, b and c slices of one wider tensor
    xbc = torch.cat([x.reshape(2, 40, 128), b, c], dim=-1)
    xs, bs, cs = xbc[..., :128].reshape(2, 40, 4, 32), xbc[..., 128:160], \
        xbc[..., 160:]
    got = ssd_scan(xs, dt, a, bs, cs, d, chunk=16)
    want = ssd_ref.ssd_chunked(x, dt, a, b, c, d, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan(x.double(), dt, a, b.double(), c.double(), d, chunk=16)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan(x, dt, a, b.to(torch.bfloat16), c, d, chunk=16)
    with pytest.raises(ValueError, match="shape"):
        ssd_scan(x, dt, a, b[:, :20].contiguous(), c, d, chunk=16)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(x[..., :16].contiguous(), dt, a, b, c, d, chunk=16)
    with pytest.raises(ValueError, match="d_state"):
        ssd_scan(x, dt, a, b[..., :16].contiguous(),
                 c[..., :16].contiguous(), d, chunk=16)
    with pytest.raises(ValueError, match="on meta"):
        ssd_scan(x, dt.to("meta"), a, b, c, d, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, b,
                 c, d, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt.transpose(1, 2).contiguous().transpose(1, 2), a, b,
                 c, d, chunk=16)
    with pytest.raises(ValueError, match="aligned"):
        ssd_scan(x, dt, a, xbc[..., 129:161], c, d, chunk=16)
    for chunk in (0, 257):
        with pytest.raises(ValueError, match="chunk"):
            ssd_scan(x, dt, a, b, c, d, chunk=chunk)


# bf16 unless named: id, (bt, l, h, p, n, chunk)
SSD_EDGE_CASES = {
    "L1": (2, 1, 4, 64, 128, 256),
    "L_chunk": (2, 256, 8, 64, 128, 256),
    "L_chunk_plus_1": (2, 257, 8, 64, 128, 256),
    "chunk32": (2, 200, 4, 32, 64, 32),
    "chunk100": (1, 350, 9, 64, 32, 100),
    "ragged": (2, 1000, 8, 64, 128, 128),
    "overflow": (1, 512, 4, 64, 128, 256),
    "dt_zero_rows": (2, 600, 4, 64, 64, 256),
    "strided_views": (2, 300, 8, 64, 128, 128),
}


def _ssd_check_kernel(args, chunk, dtype):
    """The kernel on ``args`` (numpy float32 x, dt, a, b, c, d; x, b, c
    cast to ``dtype`` on the card) against its plain chunked version in
    float32 on the same bits: float32 y within 1e-4 of max |y|, bf16 y
    within one bf16 ulp (2^-7 rel + 1e-4 abs); the state within 1e-4 of
    max |state|; a repeat bit-identical."""
    x, dts, a, b, c, d = args
    y, s = ssd_ops.ssd(x, dts, a, b, c, d, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == (x.shape[0], x.shape[2],
                                                    x.shape[3], b.shape[-1])
    y32, s32 = ssd_ref.ssd_chunked(x.float(), dts, a, b.float(), c.float(),
                                   d, chunk=min(chunk, x.shape[1]))
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(s).all())
    if dtype == torch.float32:
        torch.testing.assert_close(y, y32, rtol=0,
                                   atol=1e-4 * float(y32.abs().max()))
    else:
        assert bool(((y.float() - y32).abs()
                     <= BF16_ULP_ATOL + BF16_ULP_RTOL * y32.abs()).all())
    torch.testing.assert_close(s, s32, rtol=0,
                               atol=1e-4 * float(s32.abs().max()))
    y2, s2 = ssd_ops.ssd(x, dts, a, b, c, d, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("bt,l,h,p,n,chunk,dtype", SSD_CARD_CASES)
def test_ssd_kernel_matches_plain(cuda_device, bt, l, h, p, n, chunk,
                                  dtype):
    """The kernel against its plain chunked version on the same inputs
    (``_ssd_check_kernel``'s bars), one launch count per call."""
    dt_ = getattr(torch, dtype)
    x, dts, a, b, c, d = (torch.as_tensor(v).to(cuda_device) for v in
                          _ssd_inputs(bt, l, h, p, n, seed=l))
    before = ssd_scan.launches
    _ssd_check_kernel((x.to(dt_), dts, a, b.to(dt_), c.to(dt_), d), chunk,
                      dt_)
    assert ssd_scan.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_EDGE_CASES))
def test_ssd_kernel_edges(cuda_device, case):
    """The bf16 kernel at its edges: L = 1, L = chunk and chunk + 1, chunks
    below the 64-row query tile (32, 100; H=9 leaves a partial head
    group), a ragged L, A = -48 with large dt (every exponent would
    overflow unless only non-positive differences are exponentiated), rows
    and a whole chunk with dt = 0, and x, B and C as slices of one wider
    tensor (the model's conv output)."""
    bt, l, h, p, n, chunk = SSD_EDGE_CASES[case]
    x, dts, a, b, c, d = (torch.as_tensor(v).to(cuda_device) for v in
                          _ssd_inputs(bt, l, h, p, n, seed=l + h))
    if case == "overflow":
        a = torch.full_like(a, -48.0)
        dts = dts * 50.0                  # dt ~ 5: cs reaches -6e4
    if case == "dt_zero_rows":
        dts[:, ::3] = 0.0
        dts[:, 256:512] = 0.0
    x, b, c = (v.to(torch.bfloat16) for v in (x, b, c))
    if case == "strided_views":
        di = h * p
        xbc = torch.cat([x.reshape(bt, l, di), b, c,
                         torch.zeros(bt, l, 8, dtype=x.dtype,
                                     device=cuda_device)], dim=-1)
        x = xbc[..., :di].reshape(bt, l, h, p)
        b, c = xbc[..., di:di + n], xbc[..., di + n:di + 2 * n]
        assert not (x.is_contiguous() or b.is_contiguous())
    before = ssd_scan.launches
    _ssd_check_kernel((x, dts, a, b, c, d), chunk, torch.bfloat16)
    assert ssd_scan.launches == before + 2


def _noma_rows(case, rng):
    """(B, M, U) SIC operands at the segmented scan's edges; the last
    position of every group gets a tiny inter (1e-30), so a suffix that
    is not exactly 0.0 there would move its rate by orders of
    magnitude."""
    b, m, u = {"singletons": (2, 5, 300), "one_group": (1, 4, 1250),
               "ragged77": (2, 6, 77), "ragged1000": (1, 3, 1000),
               "zero_contrib": (2, 4, 300)}[case]
    if case == "singletons":
        sizes = [1] * u
    elif case == "one_group":
        sizes = [u]
    else:
        sizes = []
        while sum(sizes) < u:
            sizes.append(int(min(rng.integers(1, 60), u - sum(sizes))))
    gend = np.repeat(np.cumsum(sizes) - 1, sizes).astype(np.int32)
    contrib = rng.exponential(size=(b, m, u)).astype(np.float32)
    if case == "zero_contrib":
        contrib[:] = 0.0
    sig = rng.exponential(size=(b, m, u)).astype(np.float32)
    inter = (rng.exponential(size=(b, m, u)) + 0.1).astype(np.float32)
    last = np.r_[gend[1:] != gend[:-1], True]
    inter[..., last] = 1e-30
    bw = rng.uniform(1.0, 3.0, size=b).astype(np.float32)
    return (contrib, sig, np.broadcast_to(gend, (b, m, u)).copy(), inter,
            bw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["singletons", "one_group", "ragged77",
                                  "ragged1000", "zero_contrib"])
def test_noma_rate_kernel_segment_edges(cuda_device, case):
    """The segmented suffix scan at its edges (singleton groups, one group
    a row, U not a multiple of the 256-thread block, all-zero
    contributions), held to the plain masked matvec as the other noma_rate
    card test holds it (1e-5 relative plus 1e-5 of the max: the two sum a
    group of up to 1250 terms in different orders), with bit-identical
    repeats."""
    args = [torch.as_tensor(v).to(cuda_device)
            for v in _noma_rows(case, np.random.default_rng(7))]
    before = noma_rate.launches
    got = noma_rate(*args)
    assert noma_rate.launches == before + 1
    want = nref.noma_rate_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 *
                               float(want.abs().max()))
    assert torch.equal(got, noma_rate(*args))
