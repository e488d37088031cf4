"""Path runner ``serve``: the edge side of split inference, the port's
``SplitInferenceCluster.serve_round`` on a served model, closed loop.

Set-up: the weights are drawn on the device from the seed, in the served
dtype, a few large draws stacked over the layers, and handed to the
program as its ``Params``; each cell's channel is drawn from the seed;
the cluster bootstraps its schedules with the solver (no solve runs in
the window) and one round of the cell's shapes warms everything up.

Window: rounds back to back, each with fresh prompts from the seed for
every user of every cell; whole rounds, until ``seconds`` have passed.
Traced, the second round runs under the profiler.

Check: a sample of the served requests drawn from the seed, each prompt
with its served tokens run through the plain reference (float32,
teacher-forced); the widest gap by which a served token's logit lies
below the reference's best at its position; every request served with
its tokens in the model's table.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.lib import traffic as gen
from portbench.reference import mamba2 as ref

# the traced stretch: this round of the window, whole (opened and closed
# by the thread that serves it, between rounds)
TRACE_ROUND = 1
# rows a reference call runs at once
REF_ROWS = 4
# the warm-up round's prompts: an index no window reaches
WARMUP_ROUND = 10**6


def padded_vocab(model: dict) -> int:
    m = model["vocab_pad_multiple"]
    return -(-model["vocab_size"] // m) * m


def make_weights(model: dict, seed: int, device) -> dict:
    """Random weights in the served dtype: clipped normals scaled by
    1/sqrt(fan-in), ones for the norms and D, A = -(1..H), dt's bias the
    inverse softplus of a log-uniform [1e-3, 1e-1]; one draw per kind of
    leaf, stacked over the layers."""
    g = gen.device_generator(seed, gen.WEIGHTS, device)
    dt = getattr(torch, model["dtype"])
    f32 = torch.float32
    nl, d = model["n_layer"], model["d_model"]
    di = model["expand"] * d
    n, h = model["d_state"], di // model["head_dim"]
    dc, w = di + 2 * n, model["conv_width"]
    vp = padded_vocab(model)

    def normal(shape, fan_in):
        t = torch.empty(shape, dtype=f32, device=device).normal_(generator=g)
        return t.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in)).to(dt)

    ones = lambda *shape, dtype=dt: torch.ones(shape, dtype=dtype,
                                               device=device)
    u = torch.rand((nl, h), generator=g, device=device)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    layers = dict(
        norm1=ones(nl, d),
        in_proj=normal((nl, d, 2 * di + 2 * n + h), d),
        conv_w=normal((nl, w, dc), w),
        conv_b=torch.zeros((nl, dc), dtype=dt, device=device),
        A_log=torch.log(torch.arange(1, h + 1, dtype=f32, device=device)
                        ).expand(nl, h).contiguous(),
        dt_bias=dt0 + torch.log(-torch.expm1(-dt0)),
        D=ones(nl, h, dtype=f32),
        norm_w=ones(nl, di),
        out_proj=normal((nl, di, d), di))
    return dict(embed=normal((vp, d), d), layers=layers,
                final_norm=ones(d))


def program_model(w: dict):
    """The program's ``Params`` over the benchmark's weight tensors."""
    from torch import nn
    from repro_torch.models.common import Params
    lw = w["layers"]
    n = lw["norm1"].shape[0]
    layers = nn.ModuleList(
        Params(norm1=lw["norm1"][i],
               mixer=Params(**{k: lw[k][i] for k in (
                   "in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D",
                   "norm_w", "out_proj")}))
        for i in range(n))
    return Params(embed=w["embed"], layers=layers,
                  final_norm=w["final_norm"])


def program_config(model: dict):
    from repro_torch import configs
    return configs.get_config(model["program_config"]).replace(
        n_layers=model["n_layer"], d_model=model["d_model"],
        vocab_size=model["vocab_size"], d_state=model["d_state"],
        ssd_head_dim=model["head_dim"], ssd_expand=model["expand"],
        ssd_chunk=model["chunk_size"], conv_width=model["conv_width"],
        norm_eps=model["norm_eps"], dtype=model["dtype"],
        tie_embeddings=model["tie_embeddings"])


def setup(cfg, mix, seed, seconds, device):
    from repro_torch.core import ligd, network, profiles
    from repro_torch.serving.cluster import SplitInferenceCluster

    model = cfg["model"]
    if model["residual_in_fp32"]:
        raise ValueError("the program keeps the residual stream in the "
                         "served dtype; it cannot run residual_in_fp32")
    mcfg = program_config(model)
    if mcfg.padded_vocab != padded_vocab(model):
        raise ValueError(f"the program pads the vocabulary to "
                         f"{mcfg.padded_vocab}, the configuration to "
                         f"{padded_vocab(model)}")
    w = make_weights(model, seed, device)
    params = program_model(w)
    net = dict(cfg["network"])
    ncfg = network.NetworkConfig(**net)
    n_cells = cfg["n_cells"]
    scns = []
    for b in range(n_cells):
        assoc, links = gen.channel_chain(net, 1, 1.0, seed, b, device)
        scns.append(network._with_orderings(ncfg, assoc, *links[0]))
    prof = profiles.transformer_profile(mcfg, seq=mix["prompt_len"],
                                        device=device)
    cluster = SplitInferenceCluster(params, mcfg, prof,
                                    spec=ligd.SolverSpec(**cfg["solver"]),
                                    device=device)
    ids = [cluster.add_cell(s) for s in scns]
    cluster.start(threaded=False)
    groups = [cluster.installed_schedule(c).groups() for c in ids]
    st = dict(cfg=cfg, mix=mix, seed=seed, device=device, cluster=cluster,
              ids=ids, w=w, n_cells=n_cells, n_users=net["n_users"],
              vocab=model["vocab_size"], groups=groups,
              traffic=gen.generator(mix))
    # warm-up: one round of the cell's shapes, prompts not used in the window
    _round(st, WARMUP_ROUND)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return st


def _round(st, r):
    toks = st["traffic"].round_tokens(st["mix"], st["n_cells"],
                                      st["n_users"], st["vocab"],
                                      st["seed"], r)
    out = st["cluster"].serve_round(
        {c: toks[b] for b, c in enumerate(st["ids"])},
        decode_steps=st["mix"]["decode_steps"])
    return [[res.tokens_out for res in out[c]] for c in st["ids"]]


def window(st, seconds, stretch=None):
    """Closed-loop rounds; returns the window's record."""
    rounds, err, marks = [], [], {}
    sync = (torch.cuda.synchronize if st["device"].type == "cuda"
            else (lambda: None))
    t0 = time.monotonic()
    r = 0
    try:
        while not rounds or rounds[-1]["t1"] - t0 < seconds:
            traced = stretch is not None and r == TRACE_ROUND
            if traced:
                stretch.start()
                marks["trace_start"] = time.monotonic()
            ta = time.monotonic()
            served = _round(st, r)
            sync()
            rounds.append(dict(t0=ta, t1=time.monotonic(), served=served))
            if traced:
                stretch.stop()
                marks["trace_end"] = time.monotonic()
            r += 1
    except Exception as exc:   # noqa: BLE001 — reported by the check
        err.append(repr(exc))
    return dict(rounds=rounds, errors=err, marks=marks)


def requests_per_round(st):
    return st["n_cells"] * st["n_users"]


def e2e(st, rec):
    rounds = rec["rounds"]
    if not rounds or rec["errors"]:
        return {}
    mix = st["mix"]
    toks = len(rounds) * requests_per_round(st) * (mix["prompt_len"]
                                                    + mix["decode_steps"])
    return {"serve_tokens_per_s": toks / (rounds[-1]["t1"] - rounds[0]["t0"])}


def counts(st, rec):
    n = len(rec["rounds"]) * requests_per_round(st)
    return n, len(rec["errors"])


def ssd_rows(st):
    """The ssd calls of one round, in order, by their rows: per cell, each
    split group's 48 blocks (device and edge side together), then the
    decode prefill's over every user."""
    layers = st["cfg"]["model"]["n_layer"]
    rows = []
    for g in st["groups"]:
        for _, users in sorted(g.items()):
            rows += [len(users)] * layers
        rows += [st["n_users"]] * layers
    return rows


def release(st):
    st["cluster"].stop(drain=False)
    st.pop("cluster", None)
    from repro_torch.core import sweep_graph
    sweep_graph.clear_cache()


# ---- the check -------------------------------------------------------------
def _sample(st, rec, sample_seed):
    """(round, cell, user) of the requests the check reads."""
    mix = st["mix"]
    n_req = requests_per_round(st)
    k = min(mix["check_requests"], len(rec["rounds"]) * n_req)
    picks = gen.sample(sample_seed, len(rec["rounds"]) * n_req, k)
    return [(i // n_req, (i % n_req) // st["n_users"], i % st["n_users"])
            for i in picks]


def _logit_gaps(st, rec, picks, quant=None):
    """For each picked request: the gap below the reference's best logit
    of the served token (``quant`` None), or of the token the lower
    precision puts first (the control), at each served position."""
    mix, model = st["mix"], st["cfg"]["model"]
    s_len, n_gen = mix["prompt_len"], mix["decode_steps"]
    dev = st["device"]
    gaps = []
    for i in range(0, len(picks), REF_ROWS):
        block = picks[i:i + REF_ROWS]
        draw = lambda r: st["traffic"].round_tokens(
            mix, st["n_cells"], st["n_users"], st["vocab"], st["seed"], r)
        prompts = [draw(r)[c, u] for r, c, u in block]
        served = [np.asarray(rec["rounds"][r]["served"][c][u])
                  for r, c, u in block]
        seq = np.concatenate([np.stack(prompts),
                              np.stack(served)[:, :-1]], axis=1)
        tokens = torch.as_tensor(seq, dtype=torch.int64, device=dev)
        with torch.no_grad():
            want = ref.logits_at(st["w"], model, tokens, s_len - 1)
            if quant is None:
                pick = torch.as_tensor(np.stack(served), dtype=torch.int64,
                                       device=dev)
            else:
                pick = ref.logits_at(st["w"], model, tokens, s_len - 1,
                                     quant=quant).argmax(-1)
            best = want.max(-1).values
            got = torch.gather(want, -1, pick[..., None])[..., 0]
            gaps.append((best - got).reshape(-1)[:len(block) * n_gen].cpu())
    return torch.cat(gaps).numpy()


def check(st, rec, sample_seed):
    lim = st["cfg"]["limits"]
    n_gen = st["mix"]["decode_steps"]
    vp = padded_vocab(st["cfg"]["model"])
    bad = len(rec["errors"])
    for rnd in rec["rounds"]:
        for cell in rnd["served"]:
            for toks in cell:
                toks = np.asarray(toks)
                if toks.shape != (n_gen,) or toks.min() < 0 \
                        or toks.max() >= vp:
                    bad += 1
    gap = float("inf")
    if rec["rounds"]:
        gap = float(_logit_gaps(st, rec, _sample(st, rec, sample_seed)).max())
    return [("bad_requests", float(bad), lim["bad_requests"]),
            ("token_logit_gap", gap, lim["token_logit_gap"])]


def control(st, rec, sample_seed, quant):
    """The control's reading of ``token_logit_gap``: the reference in a
    lower precision put in the program's place, on the same prompts and
    served tokens."""
    return float(_logit_gaps(st, rec, _sample(st, rec, sample_seed),
                             quant=quant).max())
