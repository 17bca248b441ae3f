"""Shared parity checks of the two frontend models (tests/test_torch_encdec.py
for seamless-m4t-large-v2, tests/test_torch_vlm.py for qwen2-vl-2b): the
same numpy-seeded tokens and frontend embeddings go through the reference
and the port at ``reduced()`` sizes, the reference's parameters carried over
by ``convert.model_params_from_jax``, its caches by ``convert.cache_from_jax``.
Everything is float32.  Tolerances, each the one its neighbour test file
states for the same quantity:

* logits within ``test_torch_lm``'s LOGIT_ATOL (2e-5 on O(1) logits) and
  1e-5 of their RMS; losses within its LOSS_ATOL (1e-5);
* every cache leaf, the cross K and V included, within
  ``test_torch_serve``'s CACHE_ATOL (the logits' 2e-5);
* the port's own prefill-then-decode against its forward within the
  reference's 0.05 gate (``test_arch_smoke.test_prefill_decode_consistency``);
* the train step at ``test_torch_lm_train``'s tolerance for phi4-mini under
  AdamW, whose helpers it runs; qwen2-vl's zero-started qkv biases take
  0.01 lr a step and 5e-3 of a leaf's movement (TRAIN_TOL).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import frontend as jfe
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import frontend as tfe
from repro_torch.models import model as tmodel
from tests import test_torch_lm_train as lmt
from tests._torch_parity import assert_close, to_np
from tests.test_torch_lm import LOGIT_ATOL, LOSS_ATOL
from tests.test_torch_serve import CACHE_ATOL, CONSISTENCY_GATE

LOGIT_REL = 1e-5
SEQ, DECODE_STEPS, CACHE_EXTRA = 64, 4, 3
# the train step: test_torch_lm_train's (loss rtol, k_strict, k_noise, r)
# for phi4-mini under AdamW; for qwen2-vl a k_strict of 0.01 lr a step and
# r 5e-3 (RWKV-6's under AdamW there).  Its qkv biases start at zero, so a
# bias leaf's RMS is its movement, O(lr), and the key bias barely moves the
# softmax at the slow rotary frequencies: 30% of bk's elements have a first
# gradient under the noise floor and move up to 0.024 lr apart in the two
# packages (k_noise), which puts bk's difference at 1.05e-3 of its movement
# (r; every other leaf reads under 5e-5), and its two elements just above
# the floor move 1.3e-3 and 3e-4 lr apart (k_strict)
TRAIN_TOL = {"seamless-m4t-large-v2": lmt.TOL[("phi4-mini-3.8b", "adamw")],
             "qwen2-vl-2b": (1e-5, 0.01, 1.0, 5e-3)}


def configs(name, **changes):
    return (dataclasses.replace(jbase.get_config(name).reduced(), **changes),
            dataclasses.replace(tbase.get_config(name).reduced(), **changes))


def rel_rms(ref, out):
    a = to_np(ref).astype(np.float64)
    b = to_np(out).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))


def embeds(cfg, batch, seq, seed):
    """Frontend embeddings for a prompt of ``seq`` tokens: the frames or
    patches it carries, N(0, 1) float32."""
    t = jfe.num_frontend_tokens(cfg, seq)
    return np.random.default_rng(seed).standard_normal(
        (batch, t, jfe.frontend_dim(cfg))).astype(np.float32)


def params(cfg_j, cfg_t, seed=0):
    """The reference's random parameters in both packages.  A qkv_bias
    config's biases start at zero, so they are drawn here (N(0, 0.1)) to
    make the bias path count."""
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(seed))
    if cfg_j.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
                    if k in ("bq", "bk", "bv") else v)
                for k, v in jp["blocks"]["attn"].items()}
        jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    return jp, convert.model_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, jp), device="cpu")


def make_case(name):
    cfg_j, cfg_t = configs(name)
    jp, tp = params(cfg_j, cfg_t)
    rng = np.random.default_rng(SEQ)
    toks = rng.integers(0, cfg_j.vocab_size, (2, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, SEQ)).astype(np.int32)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jp=jp, tp=tp, toks=toks,
                labels=labels, fe=embeds(cfg_j, 2, SEQ, 1))


def check_forward(case, backend):
    """``forward_train`` logits (frontend embeddings as its third argument)
    within LOGIT_ATOL and LOGIT_REL of the reference's; the aux is 0."""
    c = case
    ref, aux_ref = jmodel.forward_train(c["cfg_j"], c["jp"],
                                        jnp.asarray(c["toks"]),
                                        jnp.asarray(c["fe"]), backend=backend)
    out, aux = tmodel.forward_train(c["cfg_t"], c["tp"],
                                    torch.tensor(c["toks"]),
                                    torch.tensor(c["fe"]), backend=backend)
    assert out.shape == (2, SEQ, c["cfg_t"].vocab_padded)
    assert rel_rms(ref, out) <= LOGIT_REL
    assert_close(ref, out, LOGIT_ATOL, f"{backend} logits")
    assert float(aux) == float(aux_ref) == 0.0


def check_lm_loss(case, backend):
    """``lm_loss`` with ``batch["frontend_embeds"]``, plain and masked (the
    second half of each sequence), within LOSS_ATOL."""
    c = case
    mask = np.zeros(c["toks"].shape, np.float32)
    mask[:, SEQ // 2:] = 1.0
    for m in (None, mask):
        jb = {"tokens": c["toks"], "labels": c["labels"], "frontend_embeds":
              c["fe"]}
        if m is not None:
            jb["mask"] = m
        ref, parts_ref = jmodel.lm_loss(c["cfg_j"], c["jp"], jax.tree.map(
            jnp.asarray, jb), backend=backend)
        out, parts = tmodel.lm_loss(c["cfg_t"], c["tp"], {
            k: torch.tensor(v) for k, v in jb.items()}, backend=backend)
        assert abs(float(ref) - float(out)) <= LOSS_ATOL, m is None
        assert abs(float(parts_ref["loss"]) - float(parts["loss"])) <= \
            LOSS_ATOL


def hold_cache(ref, out, what):
    """Every leaf of a cache: its shape, its dtype, within CACHE_ATOL."""
    assert sorted(ref) == sorted(out), what
    for k in ref:
        assert tuple(np.shape(ref[k])) == tuple(out[k].shape), (what, k)
        assert np.dtype(ref[k].dtype).name == str(out[k].dtype).split(".")[1]
        assert_close(np.asarray(ref[k], np.float32), out[k].float(),
                     CACHE_ATOL, f"{what} {k}")


def reference_prefill(case):
    c = case
    return jmodel.prefill(c["cfg_j"], c["jp"], jnp.asarray(c["toks"]),
                          cache_len=SEQ + CACHE_EXTRA,
                          frontend_embeds=jnp.asarray(c["fe"]))


def check_prefill(case, leaves):
    """Prefill of the prompt with its embeddings into a cache of S + 3:
    the next-token logits and every cache leaf (``leaves``), the K / V
    zero past S."""
    c = case
    logits_j, cache_j = reference_prefill(c)
    logits, cache = tmodel.prefill(c["cfg_t"], c["tp"],
                                   torch.tensor(c["toks"]),
                                   cache_len=SEQ + CACHE_EXTRA,
                                   frontend_embeds=torch.tensor(c["fe"]))
    assert sorted(cache) == sorted(leaves)
    assert logits.shape == (2, c["cfg_t"].vocab_padded)
    assert rel_rms(logits_j, logits) <= LOGIT_REL
    assert_close(logits_j, logits, LOGIT_ATOL, "prefill logits")
    hold_cache(cache_j, cache, "prefill")
    assert not cache["k"][:, :, SEQ:].any() and cache["k"][:, :, :SEQ].any()


def check_decode(case):
    """Four decode steps from the reference's prefilled cache (brought over
    by ``cache_from_jax``), ``pos`` an int and a 0-d tensor by turns, the
    fourth past the cache's end (clamped to its last slot): the logits and
    every cache leaf after each step, updated in place."""
    c = case
    _, cache_j = reference_prefill(c)
    cache_t = convert.cache_from_jax(c["cfg_t"], jax.tree.map(np.asarray,
                                                              cache_j),
                                     device="cpu")
    toks = np.random.default_rng(7).integers(
        0, c["cfg_j"].vocab_size, (2, DECODE_STEPS)).astype(np.int32)
    for t in range(DECODE_STEPS):
        pos, tok = SEQ + t, toks[:, t:t + 1]
        logits_j, cache_j = jmodel.decode_step(
            c["cfg_j"], c["jp"], cache_j, jnp.asarray(tok), jnp.int32(pos))
        logits, out = tmodel.decode_step(
            c["cfg_t"], c["tp"], cache_t, torch.tensor(tok),
            torch.tensor(pos) if t % 2 else pos)
        assert out is cache_t
        assert rel_rms(logits_j, logits) <= LOGIT_REL
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        hold_cache(cache_j, cache_t, f"decode {t}")


def check_consistency(name):
    """The port's twin of tests/test_arch_smoke.py's
    test_prefill_decode_consistency, its own random parameters and its
    inputs' shapes: prefill of S - 1 tokens with the embeddings of S
    into a cache of S + 2, a decode of the last token against the
    forward's logits at S - 1 within the reference's 0.05 of their
    scale."""
    cfg = tbase.get_config(name).reduced()
    p = tmodel.init_params(cfg, seed=0, device="cpu")
    S = 12
    rng = np.random.default_rng(0)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    fe = torch.tensor(embeds(cfg, 2, 16, 0))
    full, _ = tmodel.forward_train(cfg, p, toks, fe)
    _, cache = tmodel.prefill(cfg, p, toks[:, :S - 1], cache_len=S + 2,
                              frontend_embeds=fe)
    logits, _ = tmodel.decode_step(cfg, p, cache, toks[:, S - 1:], S - 1)
    ref = full[:, S - 1]
    err = float((logits - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < CONSISTENCY_GATE


def check_init_cache(name, leaves):
    """The full config's cache at B 2, 64 positions against
    ``jax.eval_shape`` of the reference's: the same leaves, shapes and
    dtypes, all zero."""
    cfg_j, cfg_t = jbase.get_config(name), tbase.get_config(name)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 2, 64))
    out = tmodel.init_cache(cfg_t, 2, 64, device="cpu")
    assert sorted(ref) == sorted(out) == sorted(leaves)
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(out[k].shape), k
        assert out[k].dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
        assert not out[k].any(), k


def check_train_step(name, monkeypatch):
    """3 AdamW steps from the same params and state on one batch of the
    ``synthetic_batch`` stream with its frontend embeddings (a fixed batch,
    as tests/test_arch_smoke.py's train step memorizes one), in 2
    microbatches, at TRAIN_TOL: the losses, every element of every leaf
    (the projector and, for the encoder-decoder, the encoder and cross
    attention among them), each leaf against the reference's movement;
    the reference's loss falls over the steps, and the port's."""
    jcfg, tcfg = configs(name, train_microbatches=2)
    data = lmt.batches(tcfg, 1) * lmt.STEPS
    assert data[0]["frontend_embeds"].shape[0] == lmt.B
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grads = lmt.reference_grads(jcfg, jp0, data[0], monkeypatch)
    jp, tp, losses = lmt.train_both(jcfg, tcfg, data)
    tol = TRAIN_TOL[name]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]
    faults, noise = lmt.param_faults(tol, jp0, jp, tsteps.param_leaves(tp),
                                     grads)
    assert faults == [] and noise <= lmt.NOISE_SHARE, (faults, noise)


def check_microbatch_split(name, monkeypatch):
    """``make_train_step`` with 2 microbatches hands ``lm_loss`` each
    half of the batch, the frontend embeddings cut with the tokens."""
    _, cfg = configs(name, train_microbatches=2)
    p = tmodel.init_params(cfg, seed=0, device="cpu")
    batch = lmt.batches(cfg, 1)[0]
    seen = []
    real = tmodel.lm_loss

    def spy(cfg_, params_, mb, **kw):
        seen.append({k: v.clone() for k, v in mb.items()})
        return real(cfg_, params_, mb, **kw)

    monkeypatch.setattr(tsteps.M, "lm_loss", spy)
    state = tsteps.make_opt(cfg).init(tsteps.param_leaves(p))
    tsteps.make_train_step(cfg)(p, state, 0, batch)
    half = lmt.B // 2
    assert len(seen) == 2
    for i, mb in enumerate(seen):
        assert sorted(mb) == ["frontend_embeds", "labels", "tokens"]
        for k, v in mb.items():
            assert np.array_equal(v.numpy(),
                                  batch[k][i * half:(i + 1) * half]), k


def check_synthetic_batch(name):
    """``synthetic_batch`` with the model config, at three (seed, step):
    every array, the embeddings drawn after the tokens, equal to the
    reference's bit for bit."""
    cfg_j, cfg_t = jbase.get_config(name), tbase.get_config(name)
    for seed, step, seq in ((0, 0, 64), (3, 7, 4096), (11, 2, 20)):
        kw = dict(vocab_size=cfg_t.vocab_size, seq_len=seq, global_batch=2,
                  seed=seed)
        ours = tpipe.synthetic_batch(tpipe.LMDataConfig(**kw), step, cfg_t)
        ref = jpipe.synthetic_batch(jpipe.LMDataConfig(**kw), step, cfg_j)
        assert sorted(ours) == sorted(ref) == ["frontend_embeds", "labels",
                                               "tokens"]
        assert ours["frontend_embeds"].shape == (
            2, tfe.num_frontend_tokens(cfg_t, seq), tfe.frontend_dim(cfg_t))
        for k in ours:
            assert ours[k].dtype == ref[k].dtype
            assert np.array_equal(ours[k], ref[k]), k


def check_model_flops(name):
    """The parameter counts and ``model_flops`` of train_4k, prefill_32k
    and decode_32k equal the reference's."""
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    jshape = jsteps.abstract_params(jcfg)
    tshape = tsteps.abstract_params(tcfg)
    assert troof.param_count(tcfg, tshape) == jroof.param_count(jcfg, jshape)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        ours = troof.model_flops(tcfg, tbase.INPUT_SHAPES[shape], tshape)
        assert ours == jroof.model_flops(jcfg, jbase.INPUT_SHAPES[shape],
                                         jshape), shape
    return troof.param_count(tcfg, tshape)


def check_prefill_step(name):
    """``make_prefill_step``'s ``prefill_step(params, tokens,
    frontend_embeds)`` and ``make_serve_step`` compute exactly what
    ``prefill`` and ``decode_step`` do."""
    _, cfg = configs(name)
    p = tmodel.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    fe = torch.tensor(embeds(cfg, 2, 16, 5))
    logits, cache = tmodel.prefill(cfg, p, toks, frontend_embeds=fe)
    lg, c = tsteps.make_prefill_step(cfg, backend="pallas")(p, toks, fe)
    assert torch.equal(lg, logits)
    assert sorted(c) == sorted(cache)
    assert all(torch.equal(c[k], cache[k]) for k in cache)
    want, _ = tmodel.decode_step(cfg, p, {k: v.clone() for k, v in
                                          cache.items()}, toks[:, :1], 16)
    got, _ = tsteps.make_serve_step(cfg)(p, c, toks[:, :1], 16)
    assert torch.equal(got, want)


def check_launch_train(name):
    """``python -m repro_torch.launch.train --arch <name> --reduced --steps
    10`` on the CPU (the synthetic stream with its embeddings) exits 0 and
    its loss falls."""
    out = lmt.run_module("repro_torch.launch.train", "--arch", name,
                         "--reduced", "--steps", "10", "--device", "cpu")
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")][0]
    assert float(final.split()[2]) < float(final.split()[4][:-1])

