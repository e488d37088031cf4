"""Path runner ``serve_mixtral``: the edge side of split inference on a
sparse-expert model, the port's ``SplitInferenceCluster.serve_round`` on
Mixtral with its MoE dropless, closed loop.

It is ``paths/serve.py`` with Mixtral's weights, configuration and
reference: the window, the end-to-end numbers, the counts, the rounds
and the check's sample are that runner's (loaded by name, not edited).

Set-up: the program must have the dropless MoE (``capacity_factor``
None), else the run stops at once; the weights are drawn on the device
from the seed, in the served dtype (the router in float32), a layer at
a time, stacked over the layers, and handed to the program as its
``Params``; each cell's channel is drawn from the seed; the cluster
bootstraps its schedules with the solver (no solve runs in the window),
which must put every user of a cell at split 0, one split group a cell,
as the traffic has it (else the run stops); one round of the cell's
shapes warms everything up.

Check: a sample of the served requests drawn from the seed, each prompt
with its served tokens run through the plain reference (float32,
teacher-forced, a layer at a time).  The served path: each sampled
request's cell run again through ``engine.execute_schedule`` on its
installed schedule (the prefill, the hand-off and the decode steps a
round runs, at the served batch), each decode step fed the served token;
its routes and logits at every served position held to the
reference's.  Each of the program's layers on the reference's own
input, its routes and its outputs held to the reference's layer.  The
widest gap by which a served token's logit lies below the reference's
best at its position; every request served with its tokens in the
model's table; and the routes the program dropped in the window (its
device-side counter, read once after the window).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib import common
from portbench.lib import traffic as gen
from portbench.reference import mixtral as ref

_serve = common.load_module("paths", "serve")
e2e, counts, release = _serve.e2e, _serve.counts, _serve.release
requests_per_round = _serve.requests_per_round

# rows a reference call runs at once
REF_ROWS = 8
# the numbers the comparison with the reference gives (``_compare``)
COMPARED = ("token_logit_gap", "served_route_flips", "served_logit_gap",
            "block_route_flips", "block_output_gap")
# the configuration's attention, as the program's mixer
MIXERS = {"global": "attn", "sliding": "local"}


def make_weights(model: dict, seed: int, device) -> dict:
    """Random weights: clipped normals scaled by 1/sqrt(fan-in), in the
    served dtype (the router float32), ones for the norms; each layer's
    leaf drawn apart (a float32 draw of a whole stack would not fit) into
    a tensor stacked over the layers."""
    g = gen.device_generator(seed, gen.WEIGHTS, device)
    dt = getattr(torch, model["dtype"])
    f32 = torch.float32
    nl, d, f = model["n_layers"], model["d_model"], model["d_ff"]
    h, k, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    e, v = model["n_experts"], model["vocab_size"]

    def normal(shape, fan_in, dtype=dt):
        t = torch.empty(shape, dtype=f32, device=device).normal_(generator=g)
        return t.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in)).to(dtype)

    def stacked(shape, fan_in, dtype=dt):
        out = torch.empty((nl,) + shape, dtype=dtype, device=device)
        for i in range(nl):
            out[i] = normal(shape, fan_in, dtype)
        return out

    ones = lambda *shape: torch.ones(shape, dtype=dt, device=device)
    layers = dict(
        norm1=ones(nl, d), wq=stacked((d, h, hd), d),
        wk=stacked((d, k, hd), d), wv=stacked((d, k, hd), d),
        wo=stacked((h, hd, d), h * hd), norm2=ones(nl, d),
        router=stacked((d, e), d, f32), w_in=stacked((e, d, f), d),
        w_gate=stacked((e, d, f), d), w_out=stacked((e, f, d), f))
    return dict(embed=normal((v, d), d), layers=layers, final_norm=ones(d),
                lm_head=normal((d, v), d))


def program_model(w: dict):
    """The program's ``Params`` over the benchmark's weight tensors."""
    from torch import nn
    from repro_torch.models.common import Params
    lw = w["layers"]
    layers = nn.ModuleList(
        Params(norm1=lw["norm1"][i],
               mixer=Params(**{n: lw[n][i] for n in ("wq", "wk", "wv",
                                                     "wo")}),
               norm2=lw["norm2"][i],
               ffn=Params(**{n: lw[n][i] for n in ("router", "w_in",
                                                   "w_gate", "w_out")}))
        for i in range(lw["norm1"].shape[0]))
    return Params(embed=w["embed"], layers=layers,
                  final_norm=w["final_norm"], lm_head=w["lm_head"])


def program_config(model: dict):
    from repro_torch import configs
    return configs.get_config(model["program_config"]).replace(
        n_layers=model["n_layers"], d_model=model["d_model"],
        n_heads=model["n_heads"], n_kv_heads=model["n_kv_heads"],
        head_dim=model["head_dim"], d_ff=model["d_ff"],
        n_experts=model["n_experts"], top_k=model["top_k"],
        vocab_size=model["vocab_size"], rope_theta=model["rope_theta"],
        norm_eps=model["norm_eps"], dtype=model["dtype"],
        tie_embeddings=model["tie_embeddings"],
        pattern=((MIXERS[model["attention"]], "moe"),),
        capacity_factor=model["capacity_factor"])


def setup(cfg, mix, seed, seconds, device):
    from repro_torch.models import moe
    if not hasattr(moe, "dropless"):
        raise RuntimeError("the program's MoE has no dropless path "
                           "(capacity_factor=None): it would drop routes")
    from repro_torch.core import ligd, network, profiles
    from repro_torch.serving.cluster import SplitInferenceCluster

    model = cfg["model"]
    mcfg = program_config(model)
    if mcfg.padded_vocab != model["vocab_size"]:
        raise ValueError(f"the program pads the vocabulary to "
                         f"{mcfg.padded_vocab}, the model has "
                         f"{model['vocab_size']}")
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
    n_users = net["n_users"]
    for b, g in enumerate(groups):
        if list(g) != [0] or not np.array_equal(g[0], np.arange(n_users)):
            raise RuntimeError(
                f"cell {b}'s schedule splits its users as "
                f"{ {s: u.tolist() for s, u in g.items()} }: the traffic "
                f"puts every user at split 0, one split group a cell")
    st = dict(cfg=cfg, mix=mix, seed=seed, device=device, cluster=cluster,
              ids=ids, w=w, params=params, mcfg=mcfg, n_cells=n_cells,
              n_users=n_users, vocab=model["vocab_size"], groups=groups,
              traffic=gen.generator(mix))
    _serve._round(st, _serve.WARMUP_ROUND)
    # what each cell's round runs on, for the check's replay (taken after
    # the warm-up round, whose snapshot of the version came first)
    st["snapshot"] = cluster.engine.round_snapshot()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return st


def window(st, seconds, stretch=None):
    """``serve.py``'s window; the program's count of dropped routes is
    zeroed before it and read once after."""
    from repro_torch.models import moe
    moe.DROPPED_ROUTES.reset()
    rec = _serve.window(st, seconds, stretch)
    rec["dropped_routes"] = moe.DROPPED_ROUTES.read()
    return rec


def flash_calls(st):
    """The flash kernel's calls of one round, in order, as (rows, tokens):
    per cell, each split group's attention layers (device and edge side
    together) over its users' prompts; decode attends through the cache
    without it."""
    layers = st["cfg"]["model"]["n_layers"]
    s = st["mix"]["prompt_len"]
    out = []
    for g in st["groups"]:
        for _, users in sorted(g.items()):
            out += [(len(users), s)] * layers
    return out


# ---- the check -------------------------------------------------------------
def _program_block(st, i, x):
    """The program's layer ``i`` on the reference's input ``x`` (float32,
    cast to the served dtype), through its own block; returns its output
    in float32 and the experts (R·L, k) its router gives each token (the
    block's attention recomputed for them: the kernels are
    deterministic)."""
    from repro_torch.models import attention, blocks, moe
    from repro_torch.models.common import positions_for, rms_norm
    cfg, layer = st["mcfg"], st["params"].layers[i]
    mixer = cfg.layer_specs[i][0]
    r, l, d = x.shape
    xb = x.to(getattr(torch, cfg.dtype))
    pos = positions_for(cfg, r, l, device=x.device)
    out, _ = blocks.forward(layer, cfg, cfg.layer_specs[i], xb, pos)
    x1 = xb + attention.forward(layer.mixer, cfg,
                                rms_norm(xb, layer.norm1, cfg.norm_eps), pos,
                                mixer=mixer)
    idx, _, _ = moe.route(layer.ffn, cfg, rms_norm(
        x1, layer.norm2, cfg.norm_eps).reshape(r * l, d))
    return out.float(), idx


def _program_served(st, rec, picks):
    """The program's served path run again for the picked requests: each
    one's cell through ``engine.execute_schedule`` on its installed
    schedule (the call a round makes for each cell: the prefill, decode's
    start, the decode steps at their positions, the served batch), with
    every decode step fed the served token in place of its own.  Returns
    the float32 logits (P, G, V) at the G served positions and the
    experts (P, n_layers, G, k) each layer routes them to, read from the
    program's router as it runs."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine, split_runtime
    mix = st["mix"]
    s, n_gen, dev = mix["prompt_len"], mix["decode_steps"], st["device"]
    ss, scns, profs = st["snapshot"]
    real = (moe._route, split_runtime.split_inference, T.decode_step)
    routes, logits, forced = [], [], []

    def route(*args):
        out = real[0](*args)
        routes.append(out[0])
        return out

    def prefill(*args, **kw):
        out, bits = real[1](*args, **kw)
        logits.append(out[:, -1].clone())
        return out, bits

    def decode(params, cfg, tokens, pos, caches, **kw):
        out, caches = real[2](params, cfg, forced[0][:, len(logits) - 1],
                              pos, caches, **kw)
        logits.append(out)
        return out, caches

    got = {}
    moe._route, split_runtime.split_inference, T.decode_step = \
        route, prefill, decode
    try:
        for r, c in sorted({(r, c) for r, c, _ in picks}):
            toks = st["traffic"].round_tokens(
                mix, st["n_cells"], st["n_users"], st["vocab"], st["seed"],
                r)[c]
            forced[:] = [torch.as_tensor(
                np.stack(rec["rounds"][r]["served"][c]), device=dev)]
            routes.clear()
            logits.clear()
            engine.execute_schedule(st["params"], st["mcfg"], scns[c].cfg,
                                    profs[c], ss.schedules[c], toks,
                                    decode_steps=n_gen)
            # the prefill's routes (one call a layer over the cell's U·S
            # tokens; one split group, users in order), then each step's
            n_layers = len(routes) // n_gen
            idx = torch.stack(
                [x.view(st["n_users"], -1, x.shape[-1])[:, -1]
                 for x in routes], 1).unflatten(1, (n_gen, n_layers))
            steps = torch.stack(logits, 1)
            for u in range(st["n_users"]):
                got[(r, c, u)] = (steps[u], idx[u].transpose(0, 1))
    finally:
        moe._route, split_runtime.split_inference, T.decode_step = real
    return (torch.stack([got[p][0] for p in picks]),
            torch.stack([got[p][1] for p in picks]))


def _compare(st, rec, picks, quant=None):
    """One pass of the plain reference (float32) over the picked requests,
    a layer at a time, against the program (``quant`` None) or the
    reference in a lower precision (the control) in its place.

    The served path (the program's from ``_program_served``; the
    control's, its own full forward): at each served position, the share
    of (position, layer, slot) routes to an expert that the reference's
    position does not route to (``served_route_flips``), and, at the
    positions where every layer's routes agree, the largest logit gap
    over the reference's largest logit (``served_logit_gap``).  Each
    layer on the reference's own input: the share of routes whose expert
    differs (``block_route_flips``, the largest over the layers), and
    the largest gap between the outputs of tokens whose routes all agree
    over the largest output (``block_output_gap``).  The gap below the
    reference's best logit of the served token, or of the token the
    lower precision puts first (``token_logit_gap``)."""
    mix, model = st["mix"], st["cfg"]["model"]
    s_len, n_gen = mix["prompt_len"], mix["decode_steps"]
    n_layers = model["n_layers"]
    dev = st["device"]
    draw = lambda r: st["traffic"].round_tokens(
        mix, st["n_cells"], st["n_users"], st["vocab"], st["seed"], r)
    flips, routes = [0] * n_layers, [0] * n_layers
    off, big = [0.0] * n_layers, [0.0] * n_layers
    gaps, served_flips, served_routes, served_gaps = [], 0, 0, []
    with torch.no_grad():
        if quant is None:
            p_logits, p_routes = _program_served(st, rec, picks)
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
                    st["w"], model, tokens, s_len - 1, quant)
            x = ref.embed(st["w"], tokens)
            want_routes = []
            for j in range(n_layers):
                lw = ref.layer(st["w"], j)
                want, want_idx = ref.block(x, lw, model)
                got, got_idx = (_program_block(st, j, x) if quant is None
                                else ref.block(x, lw, model, quant))
                del lw
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
            logits = ref.head(st["w"], model, x, s_len - 1)
            del x
            # a route flips where the program's expert is none of the
            # reference's at that position and layer
            miss = ~(got_routes[..., :, None] == torch.stack(
                want_routes, 1)[..., None, :]).any(-1)
            served_flips += int(miss.sum())
            served_routes += miss.numel()
            agree = ~miss.any(-1).any(1)                       # (R, G)
            rel = (got_logits - logits).abs().amax(-1) \
                / logits.abs().amax(-1)
            served_gaps.append(rel[agree].cpu())
            pick = (torch.as_tensor(served, dtype=torch.int64, device=dev)
                    if quant is None else got_logits.argmax(-1))
            best = logits.max(-1).values
            chosen = torch.gather(logits, -1, pick[..., None])[..., 0]
            gaps.append((best - chosen).reshape(-1)[:len(block) * n_gen]
                        .cpu())
            del logits, got_logits
    served_gaps = torch.cat(served_gaps)
    return dict(
        token_logit_gap=float(torch.cat(gaps).max()),
        served_route_flips=served_flips / served_routes,
        served_logit_gap=(float(served_gaps.max()) if served_gaps.numel()
                          else math.inf),
        block_route_flips=max(f / n for f, n in zip(flips, routes)),
        block_output_gap=max(o / b for o, b in zip(off, big)))


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
