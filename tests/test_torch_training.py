"""The port's training path (``repro_torch.training``, ``launch.steps``,
``launch.train`` and ``models.transformer``'s remat) against the JAX
package on the CPU, at tiny float32 configs.

JAX runs its own plain paths (``impl="chunked"`` in the step,
``"naive"`` in the loop; no Pallas kernel is involved) and the port
trains through autograd of its plain paths: the kernels refuse
gradients, which ``test_kernel_wrappers_refuse_grad`` shows.  States
cross over through ``interop.train_state_from_numpy`` and back through
``interop.params_to_numpy``."""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_bridge import one_intra_op_thread  # noqa: F401
from port_bridge import assert_leaves_close, to_np, train_state
from repro import configs as jconfigs
from repro.data import pipeline as jpipeline
from repro.launch import steps as jsteps
from repro.models import rglru as jrglru
from repro.models import transformer as JT
from repro.training import losses as jlosses
from repro.training import optim as joptim
from repro_torch import configs, interop
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.noma_rate.kernel import noma_rate
from repro_torch.kernels.rglru_scan.kernel import rglru_scan
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models import rglru
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint, losses, optim
from repro_torch.training.loop import train

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAD_ARCHS = ["internlm2-1.8b", "gemma-2b", "llama3-8b", "recurrentgemma-2b",
              "mamba2-780m", "mixtral-8x22b", "musicgen-medium",
              "qwen2-vl-72b"]
# one ssd chunk of the tiny mamba2; below attention's q_chunk
SEQ, BATCH = 32, 2


def _cfgs(name, **kw):
    return (jconfigs.get_tiny_config(name).replace(dtype="float32", **kw),
            configs.get_tiny_config(name).replace(dtype="float32", **kw))


def _batch(cfg, b, s, seed):
    """A numpy batch in the JAX pipeline's layout."""
    rng = np.random.default_rng(seed)
    if cfg.n_codebooks > 1:
        toks = rng.integers(0, cfg.vocab_size, (b, cfg.n_codebooks, s + 1))
    else:
        toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    toks = toks.astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.vision_tokens:
        nv = cfg.vision_tokens
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (b, nv, cfg.d_model))).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.full((b, nv), -1, np.int32), out["labels"]], axis=1)
        out["positions"] = np.broadcast_to(
            np.arange(nv + s, dtype=np.int32), (b, 3, nv + s)).copy()
    return out


def _torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _jax_loss_fn(jcfg, impl="chunked"):
    """The body of JAX's ``make_train_step``."""
    def loss_fn(p, mb):
        kw = {}
        if "vision_embeds" in mb:
            kw["vision_embeds"] = mb["vision_embeds"]
            kw["positions"] = mb.get("positions")
        logits, aux = JT.forward(p, jcfg, mb["tokens"], impl=impl,
                                 remat=True, **kw)
        loss = jlosses.lm_loss(jcfg, logits, mb["labels"])
        return loss + jsteps.MOE_AUX_WEIGHT * aux, loss
    return loss_fn


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


# ------------------------------------------------------------- gradients
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    jcfg, cfg = _cfgs(arch)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    if arch == "mixtral-8x22b":
        # two equal router columns: top-k ties go to the lower expert in
        # both (the port's stable sort), so the routes and grads agree
        ffn = jstate["params"]["units"][0]["ffn"]
        router = np.asarray(ffn["router"]).copy()
        router[..., 3] = router[..., 1]
        ffn["router"] = jnp.asarray(router)
    state = train_state(cfg, jstate)
    batch = _batch(cfg, BATCH, SEQ, seed=1)
    (jtotal, jloss), jgrads = jax.value_and_grad(
        _jax_loss_fn(jcfg), has_aux=True)(jstate["params"], batch)
    total, loss, grads = steps.make_grad_fn(cfg, microbatches=1)(
        state["params"], _torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    got = interop.params_to_numpy(cfg, grads)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jgrads))
    assert_leaves_close(_leaves(got), _leaves(jgrads), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_round_trips_through_numpy(dtype):
    """A unit-and-tail layout; bfloat16 leaves keep their bits."""
    jcfg, cfg = _cfgs("recurrentgemma-2b", n_layers=5)
    jcfg, cfg = jcfg.replace(dtype=dtype), cfg.replace(dtype=dtype)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    state = train_state(cfg, jstate)
    assert all(p.requires_grad for p in state["params"].parameters())
    back = interop.train_state_to_numpy(cfg, state)
    want = jax.tree.map(np.asarray, jstate)
    assert (jax.tree_util.tree_structure(back["params"])
            == jax.tree_util.tree_structure(want["params"]))
    for got, ref in ((back["params"], want["params"]),
                     (back["opt"][1], want["opt"].m),
                     (back["opt"][2], want["opt"].v)):
        for g, w in zip(_leaves(got), _leaves(ref)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    assert int(back["opt"][0]) == int(want["opt"].step)


# ------------------------------------------------------------- optimiser
@pytest.mark.parametrize("clip", [0.5, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_apply_matches_jax(clip):
    rng = np.random.default_rng(0)
    shapes = {"w": (16, 8), "b": (8,), "e": (3, 4, 5)}
    draw = lambda s=1.0: {k: (s * rng.standard_normal(v)).astype(np.float32)
                          for k, v in shapes.items()}
    params, grads, m = draw(), draw(0.5), draw(0.1)
    v = {k: np.abs(x) for k, x in draw(0.05).items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=clip)
    jp, jst, jm = joptim.apply(
        joptim.AdamWConfig(**kw), params, grads,
        joptim.OptState(jnp.int32(4), m, v))
    t = lambda d: {k: torch.tensor(x) for k, x in d.items()}
    pp = t(params)
    _, st, om = optim.apply(optim.AdamWConfig(**kw), pp, t(grads),
                            optim.OptState(torch.tensor(4, dtype=torch.int32),
                                           t(m), t(v)))
    assert int(st.step) == int(jst.step) == 5
    for got, want in ((pp, jp), (st.m, jst.m), (st.v, jst.v)):
        for k in shapes:
            np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]),
                                       rtol=1e-6, err_msg=k)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(om[k]), float(jm[k]), rtol=1e-6)
    assert (float(om["grad_norm"]) > clip) == (clip == 0.5)


def test_grad_clip_bounds_update():
    cfg = optim.AdamWConfig(lr=1.0, grad_clip=1e-6, weight_decay=0.0,
                            warmup_steps=0, total_steps=10)
    params = {"w": torch.ones((4,))}
    st = optim.init(params)
    grads = {"w": torch.full((4,), 1e6)}
    newp, _, m = optim.apply(cfg, {"w": params["w"].clone()}, grads, st)
    assert float(torch.max(torch.abs(newp["w"] - params["w"]))) < 2.0
    assert float(m["grad_norm"]) > 1e5


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(optim.schedule(cfg, s)) for s in (1, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] >= cfg.lr * cfg.min_lr_frac * 0.99
    jcfg = joptim.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(
        lrs, [float(joptim.schedule(jcfg, jnp.int32(s)))
              for s in (1, 5, 10, 50, 100)], rtol=1e-6)


def test_loss_masks_vision_positions_and_padding():
    cfg = configs.get_tiny_config("qwen2-vl-72b")
    logits = torch.zeros((1, 8, cfg.padded_vocab))
    labels = torch.cat([torch.full((1, 4), -1, dtype=torch.int32),
                        torch.zeros((1, 4), dtype=torch.int32)], dim=1)
    ce = float(losses.cross_entropy(logits, labels, cfg.vocab_size))
    np.testing.assert_allclose(ce, np.log(cfg.vocab_size), rtol=1e-5)


# ----------------------------------------------------------------- steps
STEP_CASES = [(1, "float32"), (2, "float32"), (2, "bfloat16")]


@pytest.mark.parametrize("nm,accum", STEP_CASES,
                         ids=["nm1", "nm2", "nm2-bf16-accum"])
def test_train_steps_match_jax(nm, accum):
    """Three steps from one JAX state on JAX's batches: the loss history
    within rtol 1e-4."""
    jcfg, cfg = _cfgs("llama3-8b")
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(0))
    state = train_state(cfg, jstate)
    data = jpipeline.for_config(jcfg, 32, 8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, joptim.AdamWConfig(**kw), microbatches=nm,
        accum_dtype=getattr(jnp, accum)))
    pstep = steps.make_train_step(
        cfg, optim.AdamWConfig(**kw), microbatches=nm,
        accum_dtype=getattr(torch, accum))
    for i in range(3):
        batch = jax.tree.map(np.asarray, data.batch(0, i))
        jstate, jm = jstep(jstate, batch)
        state, m = pstep(state, _torch(batch))
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    assert int(state["opt"].step) == 3


def test_microbatch_equivalence():
    """nm=2 gradient accumulation ≈ the single-batch step (f32
    accumulation), within the JAX suite's 1e-4."""
    cfg = configs.get_tiny_config("llama3-8b").replace(dtype="float32")
    batch = _torch(_batch(cfg, 8, 32, seed=2))
    out = []
    for nm in (1, 2):
        state = steps.init_train_state(cfg, device=CPU)
        state, m = steps.make_train_step(cfg, microbatches=nm)(state, batch)
        out.append((float(m["loss"]), state["params"]))
    (l1, p1), (l2, p2) = out
    assert abs(l1 - l2) < 1e-4
    diff = max(float((a - b).detach().abs().max())
               for a, b in zip(p1.parameters(), p2.parameters()))
    assert diff < 1e-4


@pytest.mark.parametrize("arch,kw", [("recurrentgemma-2b", {"n_layers": 5}),
                                     ("mixtral-8x22b", {})],
                         ids=["rg2b-unit-and-tail", "mixtral-moe-aux"])
def test_remat_is_bitwise(arch, kw):
    """``remat=True`` recomputes each pattern unit in the backward pass:
    the logits, the MoE aux loss and every gradient equal the stored
    forward's bit for bit."""
    _, cfg = _cfgs(arch, **kw)
    model = T.init(torch.Generator().manual_seed(0), cfg, CPU)
    model.requires_grad_(True)
    tokens = torch.as_tensor(_batch(cfg, 2, 64, seed=3)["tokens"])
    params = list(model.parameters())
    out = []
    for remat in (False, True):
        logits, aux = T.forward(model, cfg, tokens, impl="chunked",
                                remat=remat)
        loss = logits.square().mean() + steps.MOE_AUX_WEIGHT * aux
        out.append((logits, aux, torch.autograd.grad(loss, params)))
    (l0, a0, g0), (l1, a1, g1) = out
    assert torch.equal(l0, l1)
    if cfg.n_experts:
        assert a1.requires_grad and torch.equal(a0, a1)
    for x, y in zip(g0, g1):
        assert torch.equal(x, y)


def test_step_tables_and_shape_rules_match_jax():
    assert steps.SHAPES == jsteps.SHAPES
    assert steps.MICROBATCHES == jsteps.MICROBATCHES
    assert steps.MOE_AUX_WEIGHT == jsteps.MOE_AUX_WEIGHT
    for arch in configs.list_architectures():
        for shape in steps.SHAPES:
            assert steps.shape_applicable(configs.get_config(arch), shape) \
                == jsteps.shape_applicable(jconfigs.get_config(arch), shape)


def test_prefill_and_decode_steps_match_jax():
    jcfg, cfg = _cfgs("llama3-8b")
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    model = interop.model_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                     device=CPU)
    batch = _batch(cfg, BATCH, SEQ, seed=6)
    want = jsteps.make_prefill_step(jcfg)(jparams, batch)
    got = steps.make_prefill_step(cfg)(model, _torch(batch))
    assert_leaves_close([got], [want], 1e-5)
    _, jcaches, _ = JT.prefill(jparams, jcfg, batch["tokens"], SEQ + 1)
    _, caches, _ = T.prefill(model, cfg, _torch(batch)["tokens"], SEQ + 1)
    nxt = batch["labels"][:, -1]
    jlogits, _ = jsteps.make_decode_step(jcfg)(jparams, nxt, SEQ, jcaches)
    logits, _ = steps.make_decode_step(cfg)(model, torch.as_tensor(nxt),
                                            SEQ, caches)
    assert_leaves_close([logits], [jlogits], 1e-5)


# ------------------------------------------------------------ loop, ckpt
def test_loss_decreases():
    cfg = configs.get_tiny_config("internlm2-1.8b").replace(dtype="float32")
    _, hist = train(cfg, steps=25, seq_len=48, global_batch=8, log_every=5,
                    device=CPU)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3
    for key in ("loss", "total_loss", "grad_norm", "lr", "step", "wall_s",
                "data_ms", "step_ms"):
        assert key in hist[0], key


def _state_leaves(state):
    return [x for _, x in checkpoint.leaves(state)]


def test_checkpoint_roundtrip(tmp_path):
    """bfloat16 weights and float32 moments back bit for bit."""
    cfg = configs.get_tiny_config("gemma-2b")
    assert cfg.dtype == "bfloat16"
    state = steps.init_train_state(cfg, device=CPU)
    batch = _torch(_batch(cfg, 2, 16, seed=4))
    state, _ = steps.make_train_step(cfg, impl="naive")(state, batch)
    checkpoint.save(tmp_path / "step_5", state, step=5, extra={"arch": 1})
    other = steps.init_train_state(cfg, torch.Generator().manual_seed(9),
                                   device=CPU)
    restored, step = checkpoint.restore(tmp_path / "step_5", other)
    assert step == 5
    for a, b in zip(_state_leaves(state), _state_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert checkpoint.latest_step_dir(tmp_path).name == "step_5"
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["n_leaves"] == len(_state_leaves(state))
    assert "bfloat16" in manifest["dtypes"] and manifest["extra"] == {
        "arch": 1}
    small = steps.init_train_state(cfg.replace(d_ff=256), device=CPU)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(tmp_path / "step_5", small)


def test_resume_replays_exactly(tmp_path):
    cfg = configs.get_tiny_config("internlm2-1.8b").replace(dtype="float32")
    kw = dict(seq_len=16, global_batch=4, log_every=1, device=CPU,
              opt_cfg=optim.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=4))
    whole, hist = train(cfg, steps=4, **kw)
    train(cfg, steps=2, ckpt_dir=str(tmp_path), **kw)
    assert checkpoint.latest_step_dir(tmp_path).name == "step_2"
    resumed, hist_r = train(cfg, steps=4, ckpt_dir=str(tmp_path),
                            resume=True, **kw)
    assert [h["step"] for h in hist_r] == [2, 3]
    assert [h["loss"] for h in hist_r] == [h["loss"] for h in hist[2:]]
    for a, b in zip(_state_leaves(whole), _state_leaves(resumed)):
        assert torch.equal(a, b)


def test_launcher_trains_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--tiny", "--steps", "3", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.splitlines()[-1]
    assert last.startswith("final loss: ")
    assert np.isfinite(float(last.split(": ")[1]))


def test_launcher_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "internlm2-1.8b", "--tiny",
                             "--steps", "1"])


def _launch(*flags):
    """``python -m repro_torch.launch.train`` on the tiny internlm2, on
    the CPU, one intra-op thread a process; its final loss."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--tiny", "--steps", "2", "--seq-len", "16",
         "--batch", "4", "--device", "cpu", *flags],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.splitlines()[-1]
    assert last.startswith("final loss: ")
    return float(last.split(": ")[1])


@pytest.fixture(scope="module")
def single_rank_loss():
    return _launch()


@pytest.mark.parametrize("flags", [["--data-axis", "2"],
                                   ["--model-axis", "2"], ["--dry-run"]])
def test_launcher_unported_options_raise(flags, tmp_path, monkeypatch,
                                         capsys, request):
    """The options the launcher refused until the mesh was ported now
    run: a data or model axis of 2 trains on two gloo ranks to the
    single process's loss (bf16 tiny config: within 1e-2 relative), and
    ``--dry-run`` lays the ``train_4k`` step out on the production mesh
    (the tiny config here, its record written to the port's directory)."""
    if flags == ["--dry-run"]:
        from repro_torch.launch import dryrun
        monkeypatch.setattr(dryrun, "get_config", configs.get_tiny_config)
        monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
        assert train_launcher.main(["--arch", "internlm2-1.8b", "--tiny",
                                    "--device", "cpu", *flags]) == 0
        rec = json.loads((tmp_path / "internlm2-1.8b.train_4k.16x16.json")
                         .read_text())
        assert rec["ok"] and rec["n_chips"] == 256
        assert "[ ok ] internlm2-1.8b.train_4k.16x16" in \
            capsys.readouterr().out
        return
    assert _launch(*flags) == pytest.approx(
        request.getfixturevalue("single_rank_loss"), rel=1e-2)


def test_launcher_trains_on_a_2x2_mesh(single_rank_loss):
    assert _launch("--data-axis", "2", "--model-axis", "2") == \
        pytest.approx(single_rank_loss, rel=1e-2)


# ----------------------------------------------------------------- guard
def test_kernel_wrappers_refuse_grad():
    """Each model kernel writes its output through raw pointers (no
    ``grad_fn``), so it raises when autograd would record it, on every
    device, naming the plain path; frozen or ``no_grad`` calls run."""
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)
    q, k, v = rn(1, 16, 2, 64), rn(1, 16, 1, 64), rn(1, 16, 1, 64)
    a, b = torch.rand(1, 16, 8, generator=g), rn(1, 16, 8)
    x, dt = rn(1, 32, 2, 32), torch.rand(1, 32, 2, generator=g)
    bc, ad = rn(1, 32, 32), -torch.rand(2, generator=g)
    calls = {
        "flash_attention": (lambda: flash_attention_bshd(q, k, v), (q, k, v)),
        "rglru_scan": (lambda: rglru_scan(a, b), (a, b)),
        "ssd_scan": (lambda: ssd_scan(x, dt, ad, bc, bc, ad, chunk=32),
                     (x, dt, bc)),
    }
    for name, (call, inputs) in calls.items():
        call()
        for t in inputs:
            t.requires_grad_(True)
            with pytest.raises(RuntimeError, match=name + ".*impl="):
                call()
            with torch.no_grad():
                call()
            t.requires_grad_(False)
    c = torch.rand(1, 4, 6, generator=g, requires_grad=True)
    key = torch.zeros((1, 4, 6), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="noma_rate"):
        noma_rate(c, c, key, c, torch.ones(1))


def test_kernel_path_refuses_training_and_plain_paths_train():
    _, cfg = _cfgs("recurrentgemma-2b")
    state = steps.init_train_state(cfg, device=CPU)
    tokens = torch.as_tensor(_batch(cfg, 2, 32, seed=5)["tokens"])
    with pytest.raises(RuntimeError, match="impl="):
        T.forward(state["params"], cfg, tokens, impl="kernel")
    logits, _ = T.forward(state["params"], cfg, tokens, impl="naive")
    assert logits.requires_grad
    with torch.no_grad():      # serving: frozen or no_grad, kernel path
        T.forward(state["params"], cfg, tokens, impl="kernel")


def test_rglru_plain_scan_gradients_match_jax():
    """``rglru.forward(impl="naive")`` (the associative plain scan)
    differentiates as JAX's ``associative_scan`` path does."""
    jcfg, cfg = _cfgs("recurrentgemma-2b")
    jp = jrglru.init(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 64, cfg.d_model))).astype(np.float32)
    wy = rng.standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    wh = rng.standard_normal((2, cfg.resolved_d_rnn)).astype(np.float32)

    def jloss(p, x):
        y, h = jrglru.forward(p, jcfg, x)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jval, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, x)
    p = interop._params(jax.tree.map(np.asarray, jp), CPU)
    p.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y, h = rglru.forward(p, cfg, tx, impl="naive")
    val = (y * torch.as_tensor(wy)).sum() + (h * torch.as_tensor(wh)).sum()
    names, ps = zip(*p.named_parameters())
    grads = torch.autograd.grad(val, ps + (tx,))
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    want = [np.asarray(jgp[n]) for n in names] + [np.asarray(jgx)]
    assert_leaves_close(grads, want, 1e-5)
