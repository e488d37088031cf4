"""The port's synthetic LM pipeline (``repro_torch.data.pipeline``) on the
CPU: determinism, the JAX pipeline's shapes and dtypes for the three
layouts (text, codebooks, vision), and the law itself, held
statistically against its exact distribution (torch cannot draw
``jax.random``'s bits, so the streams are not JAX's)."""
import dataclasses

import numpy as np
import pytest
import torch

from port_bridge import one_intra_op_thread  # noqa: F401
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro_torch import configs
from repro_torch.data import pipeline

CPU = "cpu"


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_batch_is_a_pure_function_of_seed_epoch_index():
    cfg = pipeline.DataConfig(vocab_size=512, seq_len=24, global_batch=4,
                              seed=7)
    d1 = pipeline.SyntheticLM(cfg, device=CPU)
    d2 = pipeline.SyntheticLM(cfg, device=CPU)
    b = d1.batch(0, 3)
    assert _same(b, d2.batch(0, 3))
    d1.batch(1, 0)                       # draws elsewhere change nothing
    assert _same(b, d1.batch(0, 3))
    reseeded = pipeline.SyntheticLM(dataclasses.replace(cfg, seed=8),
                                    device=CPU)
    for other in (d1.batch(0, 4), d1.batch(1, 3), reseeded.batch(0, 3)):
        assert not torch.equal(b["tokens"], other["tokens"])
    it = d1.iterate(epoch=0, start=3)
    assert _same(next(it), b)
    assert _same(next(it), d1.batch(0, 4))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "musicgen-medium",
                                  "qwen2-vl-72b"])
def test_shapes_and_dtypes_match_jax(arch):
    jcfg = jconfigs.get_tiny_config(arch)
    cfg = configs.get_tiny_config(arch)
    want = jpipeline.for_config(jcfg, 16, 2, seed=0).batch(0, 0)
    got = pipeline.for_config(cfg, 16, 2, seed=0, device=CPU).batch(0, 0)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        if k in ("labels", "positions"):
            # the vision positions are ignored and the positions a ramp
            n_vis = cfg.vision_tokens
            if k == "labels" and n_vis:
                np.testing.assert_array_equal(got[k][:, :n_vis].numpy(),
                                              w[:, :n_vis])
            if k == "positions":
                np.testing.assert_array_equal(got[k].numpy(), w)
    tok = got["tokens"].numpy()
    assert tok.min() >= 0 and tok.max() < cfg.vocab_size
    # labels are the tokens shifted by one
    lab = got["labels"].numpy()[..., cfg.vision_tokens:]
    np.testing.assert_array_equal(lab[..., :-1], tok[..., 1:])
    if cfg.vision_tokens:
        ve = got["vision_embeds"].numpy()
        assert abs(ve.std() - pipeline.VISION_SCALE) < 0.1 * \
            pipeline.VISION_SCALE


def _exact_law(vocab, a, seq):
    """The chain's unigram frequencies over positions 0..seq and the
    probability that a token falls in its predecessor's bigram window,
    both exact (transition matrix from ``_zipf_logits``)."""
    base = pipeline._zipf_logits(vocab, a).astype(np.float64)
    ids = np.arange(vocab)
    target = (2 * ids + 17) % vocab
    near = np.abs(ids[None, :] - target[:, None]) < pipeline.HALF_WIDTH
    logit = base[None, :] + pipeline.BUMP * near
    trans = np.exp(logit - logit.max(1, keepdims=True))
    trans /= trans.sum(1, keepdims=True)
    p_near = (trans * near).sum(1)
    pi = np.exp(base) / np.exp(base).sum()
    marg, in_window = np.zeros(vocab), 0.0
    for t in range(seq + 1):
        marg += pi
        if t < seq:
            in_window += pi @ p_near
            pi = pi @ trans
    return marg / (seq + 1), in_window / seq


def test_streams_follow_the_zipf_bigram_law():
    vocab, seq, rows = 512, 511, 128
    cfg = pipeline.DataConfig(vocab_size=vocab, seq_len=seq,
                              global_batch=rows, seed=3)
    b = pipeline.SyntheticLM(cfg, device=CPU).batch(0, 0)
    toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).numpy()
    marg, in_window = _exact_law(vocab, cfg.zipf_a, seq)
    freq = np.bincount(toks.ravel(), minlength=vocab) / toks.size
    top = np.argsort(-marg)[:5]
    np.testing.assert_array_equal(top, np.arange(5))
    np.testing.assert_allclose(freq[top], marg[top], rtol=0.10)
    prev, nxt = toks[:, :-1], toks[:, 1:]
    share = np.mean(np.abs(nxt - (2 * prev + 17) % vocab)
                    < pipeline.HALF_WIDTH)
    assert abs(share - in_window) <= 0.02, (share, in_window)
