"""Deterministic synthetic LM data pipeline.

No external datasets ship with this system, so the pipeline synthesises
structured token streams (a Zipfian unigram mixture with Markov bigram
structure): enough signal for the loss to fall measurably, which is what
the training substrate has to show.  The law is the JAX package's:

    P(t | prev) ∝ zipf(t) · exp(2 · [|t - (2·prev + 17) mod V| < 16])

with zipf(t) ∝ (t + 1)^-a, the first token of a row drawn from zipf
alone.  Each draw is a Gumbel-max over the V logits, as
``jax.random.categorical`` draws it.

Batch i of epoch e is a pure function of (seed, e, i): it is drawn from
its own ``torch.Generator`` on the pipeline's device, seeded from
(seed, e, i), so checkpoint resume replays exactly.  torch cannot
reproduce ``jax.random``'s bits, so a seed gives other streams than the
JAX pipeline; shapes, dtypes and the law are the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.platform import resolve_device

BUMP = 2.0          # logit bonus inside the bigram window
HALF_WIDTH = 16     # |t - target| < HALF_WIDTH: 31 tokens
VISION_SCALE = 0.02


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_codebooks: int = 1
    vision_tokens: int = 0
    d_model: int = 0           # for stub vision embeddings


def _zipf_logits(vocab, a):
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-a)
    return np.log(probs / probs.sum()).astype(np.float32)


def _batch_generator(seed: int, epoch: int, index: int,
                     device) -> torch.Generator:
    """The generator of batch ``index`` of ``epoch``, on ``device``."""
    state = np.random.SeedSequence([seed, epoch, index]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) & (2**63 - 1))


class SyntheticLM:
    """Markov-modulated Zipf stream: P(t|prev) ∝ zipf(t) · bump(t ~ prev)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.base = torch.as_tensor(
            _zipf_logits(cfg.vocab_size, cfg.zipf_a), device=self.device)
        self._ids = torch.arange(cfg.vocab_size, device=self.device)

    def _categorical(self, gen, logits):
        """One Gumbel-max draw per row of ``logits`` (R, V)."""
        u = torch.rand(logits.shape, generator=gen, device=self.device)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)

    def _sample_tokens(self, gen, rows, seq):
        """(rows, seq) int32: each row its own chain, drawn in order."""
        v = self.cfg.vocab_size
        out = torch.empty((rows, seq), dtype=torch.int32, device=self.device)
        prev = self._categorical(gen, self.base.expand(rows, v))
        out[:, 0] = prev
        for t in range(1, seq):
            target = (2 * prev + 17) % v
            near = (self._ids[None, :] - target[:, None]).abs() < HALF_WIDTH
            prev = self._categorical(gen, self.base + BUMP * near)
            out[:, t] = prev
        return out

    def batch(self, epoch: int, index: int) -> dict:
        cfg = self.cfg
        gen = _batch_generator(cfg.seed, epoch, index, self.device)
        b, k = cfg.global_batch, cfg.n_codebooks
        s = cfg.seq_len + 1
        if k > 1:
            # the K codebook streams are independent chains of one law
            grid = self._sample_tokens(gen, b * k, s).view(b, k, s)
            out = {"tokens": grid[:, :, :-1], "labels": grid[:, :, 1:]}
        else:
            toks = self._sample_tokens(gen, b, s)
            out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.vision_tokens:
            out["vision_embeds"] = VISION_SCALE * torch.randn(
                (b, cfg.vision_tokens, cfg.d_model), generator=gen,
                device=self.device)
            # labels over the full (vision + text) sequence; vision = ignore
            pad = torch.full((b, cfg.vision_tokens), -1, dtype=torch.int32,
                             device=self.device)
            out["labels"] = torch.cat([pad, out["labels"]], dim=1)
            total = cfg.vision_tokens + out["tokens"].shape[1]
            pos = torch.arange(total, dtype=torch.int32, device=self.device)
            out["positions"] = pos.expand(b, 3, total)
        return out

    def iterate(self, epoch: int = 0, start: int = 0) -> Iterator[dict]:
        i = start
        while True:
            yield self.batch(epoch, i)
            i += 1


def for_config(model_cfg, seq_len, global_batch, seed=0,
               device=None) -> SyntheticLM:
    return SyntheticLM(DataConfig(
        vocab_size=model_cfg.vocab_size,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        n_codebooks=model_cfg.n_codebooks,
        vision_tokens=model_cfg.vision_tokens,
        d_model=model_cfg.d_model,
    ), device=device)
