"""Shared helpers of the ``test_torch_*`` suites: carry values built by the
JAX package into the PyTorch port through numpy (``repro_torch.interop``),
on the CPU, and compare the two sides."""
import dataclasses

import numpy as np

from repro_torch import interop

CPU = "cpu"


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
