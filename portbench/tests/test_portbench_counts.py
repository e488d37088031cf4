"""The frozen counts give the numbers measured against before: era_step
45.16 MB at B=2 and the paper's width; ssd 450.89 MB and 78.9 GFLOP at
B=16, L=2048, H=48, P=64, N=128; and the model FLOPs of a request."""
import pytest

from portbench.lib import common

era = common.load_module("counts", "era_step")
ssd = common.load_module("counts", "ssd")
mamba2 = common.load_module("counts", "mamba2")


def test_era_step_bytes():
    assert round(era.era_step_bytes(2, 250, 1250, 5) / 1e6, 2) == 45.16
    assert era.era_step_bytes(2, 250, 1250, 5) == \
        2 * era.era_step_bytes(1, 250, 1250, 5)
    assert era.gd_step_bytes(2, 250, 1250, 5) - era.era_step_bytes(
        2, 250, 1250, 5) == 4 * (2 * 2 * 1250 * 250 + 3 * 2 * 1250)


def test_ssd_counts():
    assert round(ssd.ssd_bytes(16, 2048, 48, 64, 128) / 1e6, 2) == 450.89
    assert round(ssd.ssd_ops(16, 2048, 48, 64, 128, 256) / 1e9, 1) == 78.9


def test_request_flops_against_the_shapes():
    cfg = common.config("mamba2-780m")["model"]
    d, di, n, h, p = 1536, 3072, 128, 48, 64
    per_tok = 2 * d * (2 * di + 2 * n + h) + 2 * di * d + 2 * 4 * (di + 2 * n)
    s, g = 2048, 8
    want = (48 * (s * per_tok + ssd.ssd_ops(1, s, h, p, n, 256))
            + (g - 1) * 48 * (per_tok + 4 * h * p * n) + g * 2 * d * 50277)
    assert mamba2.request_flops(cfg, s, g) == pytest.approx(want, rel=1e-12)
    # the projections dominate: about 2 x 0.7 G parameters a token
    assert 1.3e9 < per_tok * 48 < 1.5e9
