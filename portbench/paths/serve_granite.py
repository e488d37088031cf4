"""Path runner ``serve_granite``: the edge side of split inference on a
hybrid model, the port's ``SplitInferenceCluster.serve_round`` on
Granite 4.0-H (Mamba-2 layers and NoPE attention layers, each with a
dropless top-k MoE and a shared expert), closed loop.

It is ``paths/serve.py``'s window, end-to-end numbers, counts, rounds
and sample, and ``paths/serve_mixtral.py``'s window (the dropped-route
counter around it) and served-path replay, loaded by name, not edited;
the configuration file is read under the published config's own keys.

Set-up: the program must have the configuration (a shared expert, NoPE,
the multipliers), else the run stops at once; the weights are drawn on
the device from the seed, in the served dtype (the router in float32),
one dict a layer, and handed to the program as its ``Params``; each
cell's channel is drawn from the seed; the cluster bootstraps its
schedules with the solver (no solve runs in the window), which must put
every user of a cell at split 0, one split group a cell, as the traffic
has it (else the run stops); one round of the cell's shapes warms
everything up.

Check (``serve_mixtral.py``'s, against ``reference/granite.py``): a
sample of the served requests drawn from the seed, each prompt with its
served tokens run through the plain reference (float32, the SSD float64,
teacher-forced, a layer at a time).  The served path: each sampled
request's cell run again through ``engine.execute_schedule`` (prefill,
hand-off, decode at the served batch, each step fed the served token),
its routes and logits at every served position held to the
reference's.  Each of the program's layers, Mamba-2 and attention, on
the reference's own input, its routes and outputs held to the
reference's layer, and its mixer's output alone to the reference's
mixer.  The widest gap by which a served token's logit lies
below the reference's best at its position; every request served with
its tokens in the model's table; the routes the program dropped in the
window.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib import common
from portbench.lib import traffic as gen
from portbench.reference import granite as ref

_serve = common.load_module("paths", "serve")
_mixtral = common.load_module("paths", "serve_mixtral")
e2e, counts, release = _serve.e2e, _serve.counts, _serve.release
requests_per_round = _serve.requests_per_round
window = _mixtral.window

# rows a reference call runs at once
REF_ROWS = 8
# the numbers the comparison with the reference gives (``_compare``)
COMPARED = _mixtral.COMPARED + ("mixer_output_gap",)
# the configuration's layer types, as the program's mixers
MIXERS = {"mamba": "ssd", "attention": "attn"}


def layer_types(cfg: dict) -> list:
    """The mixer of each layer that runs (the first ``num_hidden_layers``
    of the published ``layer_types``)."""
    return cfg["layer_types"][:cfg["num_hidden_layers"]]


# the scale of the query and key projections over 1/sqrt(fan-in), and
# of the embedding over 1/sqrt(d) (``make_weights``)
QK_GAIN = 128 ** 0.25


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Random weights: clipped normals scaled by 1/sqrt(fan-in), in the
    served dtype (the router float32), ones for the norms and D, A =
    -(1..H), dt's bias the inverse softplus of a log-uniform [1e-3,
    1e-1]; one dict a layer.  Two scales depart from 1/sqrt(fan-in), so
    that a random model's output depends on its input as a trained one's
    does, under the published multipliers:

    - the query and key projections times ``QK_GAIN`` (128^(1/4)): under
      the published score scale of 1/128 (µP's 1/head_dim, which
      assumes trained q and k), 1/sqrt(fan-in) weights give scores of
      std ~0.09 and attention a plain mean of the values; at this gain
      the scores spread as those of 1/sqrt(fan-in) weights under
      1/sqrt(head_dim) (std ~1);
    - the embedding at 1/d, not 1/sqrt(d): with the published embedding
      multiplier 12 and the tied head, 1/sqrt(d) makes each token's own
      logit the largest by far, so that the model repeats its last
      input token whatever the layers compute."""
    g = gen.device_generator(seed, gen.WEIGHTS, device)
    dt = getattr(torch, cfg["dtype"])
    f32 = torch.float32
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    e, f, fs = (cfg["num_local_experts"], cfg["intermediate_size"],
                cfg["shared_intermediate_size"])
    nh, nk = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = ref.head_dim(cfg)
    di = cfg["mamba_expand"] * d
    n, h, w = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_conv"]
    dc = di + 2 * n

    def normal(shape, fan_in, dtype=dt):
        t = torch.empty(shape, dtype=f32, device=device).normal_(generator=g)
        return t.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    ones = lambda *shape, dtype=dt: torch.ones(shape, dtype=dtype,
                                               device=device)

    def mamba():
        u = torch.rand((h,), generator=g, device=device)
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        return dict(in_proj=normal((d, 2 * di + 2 * n + h), d),
                    conv_w=normal((w, dc), w), conv_b=normal((dc,), w),
                    A_log=torch.log(torch.arange(1, h + 1, dtype=f32,
                                                 device=device)),
                    dt_bias=dt0 + torch.log(-torch.expm1(-dt0)),
                    D=ones(h, dtype=f32), norm_w=ones(di),
                    out_proj=normal((di, d), di))

    def attention():
        return dict(wq=normal((d, nh, hd), d / QK_GAIN ** 2),
                    wk=normal((d, nk, hd), d / QK_GAIN ** 2),
                    wv=normal((d, nk, hd), d), wo=normal((nh, hd, d), nh * hd))

    layers = []
    for kind in layer_types(cfg):
        lw = dict(norm1=ones(d), norm2=ones(d))
        lw.update(mamba() if kind == "mamba" else attention())
        lw.update(router=normal((d, e), d, f32), w_in=normal((e, d, f), d),
                  w_gate=normal((e, d, f), d), w_out=normal((e, f, d), f),
                  shared_in=normal((d, fs), d), shared_gate=normal((d, fs), d),
                  shared_out=normal((fs, d), fs))
        layers.append(lw)
    return dict(embed=normal((v, d), d * d), layers=layers,
                final_norm=ones(d))


MIXER_LEAVES = {"mamba": ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                          "D", "norm_w", "out_proj"),
                "attention": ("wq", "wk", "wv", "wo")}


def program_model(w: dict, cfg: dict):
    """The program's ``Params`` over the benchmark's weight tensors."""
    from torch import nn
    from repro_torch.models.common import Params
    layers = nn.ModuleList(
        Params(norm1=lw["norm1"],
               mixer=Params(**{k: lw[k] for k in MIXER_LEAVES[kind]}),
               norm2=lw["norm2"],
               ffn=Params(router=lw["router"], w_in=lw["w_in"],
                          w_gate=lw["w_gate"], w_out=lw["w_out"],
                          shared=Params(w_in=lw["shared_in"],
                                        w_gate=lw["shared_gate"],
                                        w_out=lw["shared_out"])))
        for kind, lw in zip(layer_types(cfg), w["layers"]))
    return Params(embed=w["embed"], layers=layers,
                  final_norm=w["final_norm"])


def _refuse(cfg: dict):
    """Stop where the configuration asks for what the program's model
    does not compute."""
    want = dict(hidden_act="silu", attention_bias=False, mamba_n_groups=1,
                mamba_conv_bias=True, mamba_proj_bias=False,
                normalization_function="rmsnorm", tie_word_embeddings=True)
    off = {k: cfg[k] for k, v in want.items() if cfg[k] != v}
    if cfg["mamba_n_heads"] * cfg["mamba_d_head"] \
            != cfg["mamba_expand"] * cfg["hidden_size"]:
        off["mamba_n_heads"] = cfg["mamba_n_heads"]
    if off:
        raise ValueError(f"the program's hybrid model cannot run {off}")


def program_config(cfg: dict):
    """The program's configuration of the cell's model, or a
    ``RuntimeError`` where the program has none."""
    from repro_torch import configs
    try:
        base = configs.get_config(cfg["program_config"])
    except KeyError:
        raise RuntimeError(
            f"the program has no {cfg['program_config']} configuration (a "
            "shared expert, NoPE attention, the embedding, residual and "
            "logit multipliers): it cannot serve this model") from None
    _refuse(cfg)
    return base.replace(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=ref.head_dim(cfg),
        d_ff=cfg["intermediate_size"],
        shared_d_ff=cfg["shared_intermediate_size"],
        n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"], vocab_size=cfg["vocab_size"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=cfg["tie_word_embeddings"], dtype=cfg["dtype"],
        d_state=cfg["mamba_d_state"], ssd_head_dim=cfg["mamba_d_head"],
        ssd_expand=cfg["mamba_expand"], ssd_chunk=cfg["mamba_chunk_size"],
        conv_width=cfg["mamba_d_conv"],
        position_embedding=cfg["position_embedding_type"],
        attention_multiplier=cfg["attention_multiplier"],
        embedding_multiplier=float(cfg["embedding_multiplier"]),
        residual_multiplier=cfg["residual_multiplier"],
        logits_scaling=float(cfg["logits_scaling"]),
        pattern=tuple((MIXERS[t], "moe") for t in layer_types(cfg)),
        capacity_factor=None)


def setup(cfg, mix, seed, seconds, device):
    mcfg = program_config(cfg)
    from repro_torch.core import ligd, network, profiles
    from repro_torch.serving.cluster import SplitInferenceCluster

    if mcfg.padded_vocab != cfg["vocab_size"]:
        raise ValueError(f"the program pads the vocabulary to "
                         f"{mcfg.padded_vocab}, the model has "
                         f"{cfg['vocab_size']}")
    w = make_weights(cfg, seed, device)
    params = program_model(w, cfg)
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
    n_users = net["n_users"]
    for b, g in enumerate(groups):
        if list(g) != [0] or not np.array_equal(g[0], np.arange(n_users)):
            raise RuntimeError(
                f"cell {b}'s schedule splits its users as "
                f"{ {s: u.tolist() for s, u in g.items()} }: the traffic "
                f"puts every user at split 0, one split group a cell")
    # the attention layers' shape under the names the shared readers take
    # (``metrics/flash_roofline.py``)
    view = dict(cfg, model=dict(n_heads=cfg["num_attention_heads"],
                                head_dim=ref.head_dim(cfg),
                                n_layers=cfg["num_hidden_layers"],
                                dtype=cfg["dtype"]))
    st = dict(cfg=view, mix=mix, seed=seed, device=device, cluster=cluster,
              ids=ids, w=w, params=params, mcfg=mcfg, n_cells=n_cells,
              n_users=n_users, vocab=cfg["vocab_size"], groups=groups,
              traffic=gen.generator(mix))
    _serve._round(st, _serve.WARMUP_ROUND)
    # what each cell's round runs on, for the check's replay (taken after
    # the warm-up round, whose snapshot of the version came first)
    st["snapshot"] = cluster.engine.round_snapshot()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return st


def _calls(st, kind):
    """Per cell, each split group's rows once for every layer of the mixer
    ``kind`` (device and edge side together), in order."""
    n = layer_types(st["cfg"]).count(kind)
    out = []
    for g in st["groups"]:
        for _, users in sorted(g.items()):
            out += [len(users)] * n
    return out


def flash_calls(st):
    """The flash kernel's calls of one round, in order, as (rows,
    tokens): the attention layers' prefill calls; decode attends through
    the cache without it."""
    s = st["mix"]["prompt_len"]
    return [(rows, s) for rows in _calls(st, "attention")]


def ssd_rows(st):
    """The ssd kernel's calls of one round, in order, by their rows: the
    Mamba-2 layers' prefill calls (decode steps the state without it)."""
    return _calls(st, "mamba")


# ---- the check -------------------------------------------------------------
def _program_block(st, i, x):
    """The program's layer ``i`` on the reference's input ``x`` (float32,
    cast to the served dtype), through its own block (``blocks.prefill``,
    which takes any length); returns its output in float32, the experts
    (R·L, k) its router gives each token, read from the router as the
    block runs, and its mixer's output alone in float32 (the block's
    mixer called again on the block's normed input: the kernels are
    deterministic)."""
    from repro_torch.models import attention, blocks, moe, ssm
    from repro_torch.models.common import positions_for
    cfg, layer = st["mcfg"], st["params"].layers[i]
    spec = cfg.layer_specs[i]
    r, l, _ = x.shape
    xb = x.to(getattr(torch, cfg.dtype))
    pos = positions_for(cfg, r, l, device=x.device)
    h = blocks._norm(cfg, xb, layer.norm1)
    if spec[0] == "ssd":
        a, _ = ssm.prefill(layer.mixer, cfg, h)
    else:
        a = attention.forward(layer.mixer, cfg, h, pos, mixer=spec[0])
    del h
    real, routes = moe._route, []

    def route(*args):
        out = real(*args)
        routes.append(out[0])
        return out

    moe._route = route
    try:
        out, _, _ = blocks.prefill(layer, cfg, spec, xb, pos, max_seq=l)
    finally:
        moe._route = real
    return out.float(), routes[0], a.float()


def _compare(st, rec, picks, quant=None):
    """``serve_mixtral._compare`` against ``reference/granite.py``: one
    pass of the plain reference (float32) over the picked requests, a
    layer at a time, against the program (``quant`` None) or the
    reference in a lower precision (the control) in its place.  The
    served path (``served_route_flips``, ``served_logit_gap``), each
    layer on the reference's own input (``block_route_flips``,
    ``block_output_gap``, and ``mixer_output_gap``), and the served
    tokens' gap below the best logit (``token_logit_gap``).

    Two departures from mixtral's: ``served_logit_gap`` is, at each
    served step (the hand-off's token, then each decode step), the
    median over the requests of its largest logit gap over the
    reference's largest logit, and the largest of these over the steps
    (mixtral's is the largest over the positions where every layer's
    routes agree: with 20 layers of top-10 routes a position nearly none
    do, and a position where a route flipped may part by far more than
    the precision, which the median over requests leaves out; a fault
    of the hand-off or of a decode step parts every request at that
    step, even where it reaches only some steps);
    ``mixer_output_gap`` is new, each layer's mixer (Mamba-2 or
    attention) alone on the reference's normed input: its largest
    output gap over its largest output (the block's output is mostly
    the residual stream and the MoE's, which would hide a fault in the
    attention's positions or scale)."""
    mix, cfg = st["mix"], st["cfg"]
    s_len, n_gen = mix["prompt_len"], mix["decode_steps"]
    n_layers = cfg["num_hidden_layers"]
    dev = st["device"]
    draw = lambda r: st["traffic"].round_tokens(
        mix, st["n_cells"], st["n_users"], st["vocab"], st["seed"], r)
    flips, routes = [0] * n_layers, [0] * n_layers
    off, big = [0.0] * n_layers, [0.0] * n_layers
    mix_off, mix_big = [0.0] * n_layers, [0.0] * n_layers
    gaps, served_flips, served_routes, served_gaps = [], 0, 0, []
    with torch.no_grad():
        if quant is None:
            p_logits, p_routes = _mixtral._program_served(st, rec, picks)
    for i in range(0, len(picks), REF_ROWS):
        block = picks[i:i + REF_ROWS]
        prompts = [draw(r)[c, u] for r, c, u in block]
        served = np.stack([np.asarray(rec["rounds"][r]["served"][c][u])
                           for r, c, u in block])
        seq = np.concatenate([np.stack(prompts), served[:, :-1]], axis=1)
        tokens = torch.as_tensor(seq, dtype=torch.int64, device=dev)
        with torch.no_grad():
            if quant is None:
                got_logits = p_logits[i:i + REF_ROWS]
                got_routes = p_routes[i:i + REF_ROWS]
            else:
                got_logits, got_routes = ref.served(
                    st["w"], cfg, tokens, s_len - 1, quant)
            x = ref.embed(st["w"], cfg, tokens)
            want_routes = []
            for j in range(n_layers):
                lw = ref.layer(st["w"], cfg, j)
                want_mix = ref.mixer(x, lw, cfg)
                want, want_idx = ref.block(x, lw, cfg, a=want_mix)
                if quant is None:
                    got, got_idx, got_mix = _program_block(st, j, x)
                else:
                    got_mix = ref.mixer(x, lw, cfg, quant)
                    got, got_idx = ref.block(x, lw, cfg, quant, a=got_mix)
                del lw
                mix_off[j] = max(mix_off[j],
                                 float((got_mix - want_mix).abs().max()))
                mix_big[j] = max(mix_big[j], float(want_mix.abs().max()))
                del got_mix, want_mix
                flips[j] += int((got_idx != want_idx).sum())
                routes[j] += want_idx.numel()
                agree = (got_idx == want_idx).all(-1)
                diff = (got - want).reshape(agree.shape[0], -1)[agree]
                if diff.numel():
                    off[j] = max(off[j], float(diff.abs().max()))
                big[j] = max(big[j], float(want.abs().max()))
                want_routes.append(
                    want_idx.view(len(block), -1, want_idx.shape[-1])
                    [:, s_len - 1:])
                x = want
                del got, diff
            logits = ref.head(st["w"], cfg, x, s_len - 1)
            del x
            # a route flips where the program's expert is none of the
            # reference's at that position and layer
            miss = ~(got_routes[..., :, None] == torch.stack(
                want_routes, 1)[..., None, :]).any(-1)
            served_flips += int(miss.sum())
            served_routes += miss.numel()
            rel = (got_logits - logits).abs().amax(-1) \
                / logits.abs().amax(-1)
            served_gaps.append(rel.cpu())
            pick = (torch.as_tensor(served, dtype=torch.int64, device=dev)
                    if quant is None else got_logits.argmax(-1))
            best = logits.max(-1).values
            chosen = torch.gather(logits, -1, pick[..., None])[..., 0]
            gaps.append((best - chosen).reshape(-1)[:len(block) * n_gen]
                        .cpu())
            del logits, got_logits
    return dict(
        token_logit_gap=float(torch.cat(gaps).max()),
        served_route_flips=served_flips / served_routes,
        served_logit_gap=float(torch.cat(served_gaps).median(0)
                               .values.max()),
        block_route_flips=max(f / n for f, n in zip(flips, routes)),
        block_output_gap=max(o / b for o, b in zip(off, big)),
        mixer_output_gap=max(o / b for o, b in zip(mix_off, mix_big)))


def check(st, rec, sample_seed):
    lim = st["cfg"]["limits"]
    n_gen = st["mix"]["decode_steps"]
    bad = len(rec["errors"])
    for rnd in rec["rounds"]:
        for cell in rnd["served"]:
            for toks in cell:
                toks = np.asarray(toks)
                if toks.shape != (n_gen,) or toks.min() < 0 \
                        or toks.max() >= st["vocab"]:
                    bad += 1
    got = dict.fromkeys(COMPARED, math.inf)
    if rec["rounds"]:
        got = _compare(st, rec, _serve._sample(st, rec, sample_seed))
    return [("bad_requests", float(bad), lim["bad_requests"]),
            ("dropped_routes", float(rec["dropped_routes"]),
             lim["dropped_routes"])] + [
        (name, got[name], lim[name]) for name in COMPARED]


def control(st, rec, sample_seed, quant):
    """The control's readings of the compared numbers: the reference in a
    lower precision put in the program's place, on the same prompts and
    served tokens."""
    return _compare(st, rec, _serve._sample(st, rec, sample_seed),
                    quant=quant)
