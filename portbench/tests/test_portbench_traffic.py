"""Each generator repeats exactly from its seed, and a seed changes the
order of the work, not its amount; a mix's kind finds its generator, and
a kind with none is refused."""
import numpy as np
import pytest
import torch

from portbench.lib import common, traffic as gen

BIG = 2**31 + 12345


def test_arrivals_repeat_and_keep_their_count():
    mix = common.traffic("arrivals")
    arrivals = gen.generator(mix).arrivals
    a = arrivals(mix, 2, 1250, 20.0, BIG)
    b = arrivals(mix, 2, 1250, 20.0, BIG)
    c = arrivals(mix, 2, 1250, 20.0, BIG + 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a[0]) == len(c[0]) == 2 * 2500
    assert not np.array_equal(a[0], c[0])
    assert np.all(np.diff(a[0]) >= 0) and a[0].max() < 20.0
    q = a[3] / mix["q_base_s"]
    assert q.min() >= mix["q_lo"] and q.max() <= mix["q_hi"]


def test_channel_chain_repeats():
    net = common.config("era-paper-yolov2")["network"]
    net = dict(net, n_users=40, n_subchannels=8)
    cpu = torch.device("cpu")
    a1, l1 = gen.channel_chain(net, 3, 0.85, BIG, 1, cpu)
    a2, l2 = gen.channel_chain(net, 3, 0.85, BIG, 1, cpu)
    assert torch.equal(a1, a2)
    for (u1, d1), (u2, d2) in zip(l1, l2):
        assert torch.equal(u1, u2) and torch.equal(d1, d2)
    _, other = gen.channel_chain(net, 3, 0.85, BIG, 0, cpu)
    assert not torch.equal(other[0][0], l1[0][0])


@pytest.mark.parametrize("mix", ["prefill2k"])
def test_round_tokens_repeat(mix):
    m = common.traffic(mix)
    tokens = gen.generator(m).round_tokens
    a = tokens(m, 2, 16, 50277, BIG, 3)
    assert np.array_equal(a, tokens(m, 2, 16, 50277, BIG, 3))
    assert not np.array_equal(a, tokens(m, 2, 16, 50277, BIG, 4))
    assert a.shape == (2, 16, m["prompt_len"]) and a.max() < 50277


def test_every_mix_finds_its_generator_and_an_unknown_kind_is_refused():
    for p in sorted((common.BENCH / "traffic").glob("*.json")):
        assert gen.generator(common.load_json(p)).__doc__
    with pytest.raises(ValueError, match="flash_crowd"):
        gen.generator(dict(common.traffic("arrivals"), kind="flash_crowd"))


def test_sample_repeats():
    assert gen.sample(BIG, 100, 7) == gen.sample(BIG, 100, 7)
    assert len(set(gen.sample(BIG, 100, 7))) == 7
