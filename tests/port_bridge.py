"""Shared helpers of the ``test_torch_*`` suites: carry values built by the
JAX package into the PyTorch port through numpy (``repro_torch.interop``),
on the CPU, and compare the two sides."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch intra-op thread while a module's tests run (import it into
    the module to apply it): the suite's workers share the cores, and a
    small solve's steps are dispatch overhead, not arithmetic, so more
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scenario(jscn):
    """A JAX ``Scenario`` (single or stacked) as the port's, on the CPU."""
    arrays = {f: np.asarray(getattr(jscn, f))
              for f in ("assoc", "h_up", "h_dn", "up_order", "up_group_end",
                        "dn_order", "dn_group_end")}
    arrays["env"] = [np.asarray(v) for v in jscn.env]
    return interop.scenario_from_numpy(dataclasses.asdict(jscn.cfg), arrays,
                                       device=CPU)


def profile(jprof):
    return interop.profile_from_numpy(
        jprof.name, np.asarray(jprof.layer_flops), np.asarray(jprof.out_bits),
        np.asarray(jprof.input_bits), np.asarray(jprof.result_bits),
        device=CPU)


def allocation(jalloc):
    return interop.allocation_from_numpy([np.asarray(x) for x in jalloc],
                                         device=CPU)


def weights(jw):
    return interop.weights_from_fields(dataclasses.asdict(jw))


def to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_leaves_close(got, want, atol):
    """Each leaf scaled by the reference's max |value| (the bar of the JAX
    package's era_step suite)."""
    for i, (g, w) in enumerate(zip(got, want)):
        w, g = to_np(w), to_np(g)
        scale = np.max(np.abs(w)) + 1e-30
        np.testing.assert_allclose(g / scale, w / scale, atol=atol,
                                   err_msg=f"leaf {i}")


# the spread bar: the solver's 1e-5 wherever the JAX package's own two
# step kinds (xla and fused) agree, else twice their spread, capped
SPREAD_RTOL = 1e-5
SPREAD_CAP = 1e-3


def spread_bar(want, other, scale, whole, what):
    """Allowed |port - JAX| per element: ``SPREAD_RTOL`` of ``scale``, or
    twice the JAX package's own xla-vs-fused spread where that is larger — the
    spread of that element, or with ``whole`` the largest over the
    quantity (an allocation leaf is one trajectory's, all its users
    move together) — but never more than ``SPREAD_CAP`` of ``scale``."""
    want = np.asarray(want, np.float64)
    spread = np.abs(want - np.asarray(other, np.float64))
    if whole:
        spread = spread.max()
    scale = np.asarray(scale, np.float64)
    if np.any(2.0 * spread > SPREAD_RTOL * scale):
        print(f"{what}: bar widened by JAX's xla-vs-fused spread, "
              f"{np.max(spread / scale):.3e} of scale")
    return np.minimum(np.maximum(SPREAD_RTOL * scale, 2.0 * spread),
                      SPREAD_CAP * scale)


def assert_within_spread(got, want, other, scale, what, whole=False):
    """``got`` (port) within ``spread_bar`` of ``want`` (JAX, same step
    kind), ``other`` being JAX's value with its other step kind."""
    got = np.asarray(to_np(got), np.float64)
    err = np.abs(got - np.asarray(want, np.float64))
    bar = np.broadcast_to(spread_bar(want, other, scale, whole, what),
                          err.shape)
    assert np.all(err <= bar), (f"{what}: max err {err.max():.3e}, "
                                f"bar there {bar.flat[err.argmax()]:.3e}")


def assert_outcome(got, want, other):
    """A port ``LiGDOutcome`` against JAX's with the same step kind
    (``want``), ``other`` being JAX's with its other step kind: splits,
    iteration counts and one-hot β exactly, Γ landscape, final Γ and the
    continuous allocation leaves within ``assert_within_spread``."""
    np.testing.assert_array_equal(np.asarray(got.s), np.asarray(want.s))
    np.testing.assert_array_equal(got.iters_by_layer, want.iters_by_layer)
    assert got.total_iters == want.total_iters
    assert_within_spread(got.gamma_by_layer, want.gamma_by_layer,
                         other.gamma_by_layer, np.abs(want.gamma_by_layer),
                         "gamma_by_layer")
    assert_within_spread(got.terms.gamma, want.terms.gamma,
                         other.terms.gamma, abs(float(want.terms.gamma)),
                         "gamma")
    for name, g, w, o in zip(got.alloc._fields, got.alloc, want.alloc,
                             other.alloc):
        if name in ("beta_up", "beta_dn"):
            np.testing.assert_array_equal(to_np(g), np.asarray(w),
                                          err_msg=name)
        else:
            assert_within_spread(g, w, o, np.max(np.abs(np.asarray(w))),
                                 name, whole=True)


def train_state(cfg, jstate):
    """A JAX train state (``launch.steps.init_train_state``'s layout) as
    the port's, on the CPU."""
    import jax
    tree = jax.tree.map(np.asarray, jstate)
    return interop.train_state_from_numpy(
        cfg, {"params": tree["params"], "opt": tuple(tree["opt"])},
        device=CPU)


def per_layer(cfg, tree, is_leaf=None):
    """{name: (leaf, stacked)} of a JAX params- or caches-shaped pytree
    under the port's per-layer names: ``layers.<i>.<keys>`` for layer i
    (unit ``i // pattern_len``'s position ``i % pattern_len``, whose
    leaves are stacked over the units, or a tail block), and the
    top-level names (``embed``, ``final_norm``, ``lm_head``) as they
    are."""
    import jax

    def flat(sub):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                sub, is_leaf=is_leaf)[0]:
            keys = [str(getattr(k, "key", getattr(k, "idx", "")))
                    for k in path]
            out[".".join(keys)] = leaf
        return out

    named = {}
    for i in range(cfg.n_layers):
        u, pos = divmod(i, cfg.pattern_len)
        stacked = u < cfg.n_units
        sub = tree["units"][pos] if stacked else \
            tree["tail"][i - cfg.n_units * cfg.pattern_len]
        for k, leaf in flat(sub).items():
            named[f"layers.{i}.{k}"] = (leaf, stacked)
    for k in ("embed", "final_norm", "lm_head"):
        if k in tree:
            named[k] = (tree[k], False)
    return named
