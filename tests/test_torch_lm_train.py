"""Parity of the port's language-model training path with the reference's:
``launch.steps.make_train_step`` (microbatching, the accumulation dtypes,
remat), ``make_opt``, ``abstract_params``, ``launch.roofline``'s device
half, the bfloat16 checkpoint and its cross-read, and the two scripts
(``python -m repro_torch.launch.train``, ``...examples.quickstart``).

The reference's parameters and optimizer state come over through
``convert.model_params_from_jax`` / ``opt_state_from_jax``, its batches from
``synthetic_batch``; both packages then take 3 train steps on the CPU at
``reduced()`` sizes (float32 params; Adafactor's direction is bfloat16, as
``make_opt`` asks).  Tolerances (:data:`TOL`):

* the loss of each step within 1e-5 relative, 5e-5 (phi4-mini) and 1e-4
  (RWKV-6) for Adafactor, whose bfloat16 accumulation and update
  direction round where float32 differences straddle a boundary;
* each parameter element within 1e-4 of its leaf's RMS, plus
  ``k_strict * lr`` per step (:data:`TOL`); only an element whose
  first-step reference gradient is nonzero but at most :data:`FLOOR` of its
  leaf's gradient RMS gets ``k_noise * lr`` per step instead.  AdamW's
  first step moves every element by ``lr * g / |g|`` and Adafactor's
  unfactored statistics do the same, so an element whose gradient sits at
  float32 noise can move by up to ``lr`` either way in the two packages;
  at most :data:`NOISE_SHARE` of the elements are such.  And each leaf the
  reference moved: the RMS of the two packages' difference within ``r`` of
  the RMS of the reference's movement, which a leaf the port left alone
  fails (the planted fault).  phi4-mini's gradients agree to ~2e-5 of their
  RMS, so it is held at 1e-4 of the RMS alone under AdamW.  RWKV-6's are
  ill-conditioned in float32 (the WKV group norm): at 2 layers the
  reference's and the port's float32 gradients each sit ~3e-4 of their
  RMS from a float64 run of the port, at 6 layers ~1e-2, so there its
  elements drift up to 0.8 lr a step apart and ``r`` holds each leaf.
* the gradient a step hands its optimizer (read through a stub optimizer
  in both packages) within 1e-4 of its RMS for phi4-mini, 2e-3 for RWKV-6
  (the conditioning above), plus, where the accumulation is bfloat16
  (Adafactor), one bfloat16 ulp of each microbatch's gradient;
* with bfloat16 params, the full configs' path, the losses and each
  leaf's difference against the reference's movement (:data:`BF16_TOL`).
"""
import dataclasses
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import base as jbase
from repro.data.pipeline import LMDataConfig, synthetic_batch
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import base as tbase
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from tests._torch_parity import to_np

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("phi4-mini-3.8b", "rwkv6-3b", "qwen1.5-32b", "mistral-large-123b",
         "llama3-405b", "deepseek-v3-671b")
STEPS = 3
LR = 1e-4                     # make_opt's rate
B, S = 4, 32

# (arch, optimizer) -> (loss rtol, k_strict, k_noise, r); read on the CPU
# over 1 and 2 microbatches: loss 1.6e-7 / k_strict 0 / k_noise 0 / r 5e-5
# (phi4 adamw), 1.0e-6 / 0.042 / 0.067 / 7e-4 (rwkv adamw), 1.5e-5 /
# 0.025 / 0.002 / 1.5e-3 (phi4 adafactor, 6 layers), 3.3e-5 / 0.80 /
# 0.48 / 0.076 (rwkv adafactor, 6 layers)
TOL = {("phi4-mini-3.8b", "adamw"): (1e-5, 0.0, 1.0, 1e-3),
       ("phi4-mini-3.8b", "adafactor"): (5e-5, 0.1, 1.0, 1e-2),
       ("rwkv6-3b", "adamw"): (1e-5, 0.1, 1.0, 5e-3),
       ("rwkv6-3b", "adafactor"): (1e-4, 1.5, 1.0, 0.25)}
FLOOR = 1e-3            # of a leaf's first-step gradient RMS
NOISE_SHARE = 0.025     # of all elements (read: 0.36% to 1.6%)
GRAD_TOL = {"phi4-mini-3.8b": 1e-4, "rwkv6-3b": 2e-3}


def configs(arch, **kw):
    """The reference's and the port's reduced config, both replaced by
    ``kw``."""
    return (dataclasses.replace(jbase.get_config(arch).reduced(), **kw),
            dataclasses.replace(tbase.get_config(arch).reduced(), **kw))


def batches(cfg, n=STEPS, batch=B, seq=S):
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch)
    return [synthetic_batch(dcfg, i, cfg) for i in range(n)]


def start(jcfg, tcfg):
    """Reference params and optimizer state, and the port's copy."""
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    js = jsteps.make_opt(jcfg).init(jp)
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    ts = convert.opt_state_from_jax(tcfg, jax.tree.map(np.asarray, js),
                                    "cpu")
    return jp, js, tp, ts


def train_both(jcfg, tcfg, data):
    jp, js, tp, ts = start(jcfg, tcfg)
    jstep_fn = jax.jit(jsteps.make_train_step(jcfg))
    tstep_fn = tsteps.make_train_step(tcfg)
    jstep, tstep, losses = jnp.int32(0), 0, []
    for b in data:
        jp, js, jstep, jm = jstep_fn(jp, js, jstep,
                                     jax.tree.map(jnp.asarray, b))
        tp, ts, tstep, tm = tstep_fn(tp, ts, tstep, b)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    assert int(jstep) == tstep == len(data)
    return jp, tp, losses


def rms(a):
    return float(np.sqrt(np.mean(np.square(a.astype(np.float64)))))


def param_faults(tol, jp0, jp, tp, grads):
    """(the paths of the leaves where the port's params ``tp`` miss the
    reference's ``jp`` after the steps from ``jp0``, the share of elements
    whose first-step reference gradient ``grads`` sits at the noise
    floor), under ``tol`` (see the module docstring)."""
    _, k_strict, k_noise, r = tol
    faults, n_noise, n = [], 0, 0
    for (path, a), a0, b, g in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0], jax.tree.leaves(jp0),
            tp, grads):
        a, a0 = (np.asarray(x).astype(np.float64) for x in (a, a0))
        b = to_np(b).astype(np.float64)
        assert b.dtype == a.dtype
        noise = (g != 0) & (np.abs(g) <= FLOOR * rms(g))
        slack = np.where(noise, k_noise, k_strict) * LR * STEPS
        if ((np.abs(a - b) > 1e-4 * rms(a) + slack).any()
                or rms(a - b) > r * rms(a - a0)):
            faults.append(jax.tree_util.keystr(path))
        n_noise += int(noise.sum())
        n += g.size
    return faults, n_noise / n


def reference_grads(jcfg, jp, batch, monkeypatch):
    """The gradients the reference's first step hands its optimizer."""
    with monkeypatch.context() as m:
        m.setattr(jsteps, "make_opt", lambda cfg: jopt.Optimizer(
            lambda p: {}, lambda g, s, p, step: (g, s)))
        g = jax.jit(jsteps.make_train_step(jcfg))(
            jp, {}, jnp.int32(0), jax.tree.map(jnp.asarray, batch))[0]
    return [np.asarray(x, np.float32).astype(np.float64)
            for x in jax.tree.leaves(g)]


@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("arch,optimizer,layers", [
    ("phi4-mini-3.8b", "adamw", 2), ("rwkv6-3b", "adamw", 2),
    ("phi4-mini-3.8b", "adafactor", 6), ("rwkv6-3b", "adafactor", 6)])
def test_train_step_matches_reference(arch, optimizer, layers, n_mb,
                                      monkeypatch):
    """3 steps from the same params and state; 6 layers put Adafactor's
    stacked leaves on its per-layer path (more than 4 layers).  The check
    of the params is then shown sharp: with any leaf the reference moved
    put back to its start in the port's result, that leaf fails it."""
    jcfg, tcfg = configs(arch, optimizer=optimizer, num_layers=layers,
                         train_microbatches=n_mb)
    data = batches(tcfg)
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grads = reference_grads(jcfg, jp0, data[0], monkeypatch)
    jp, tp, losses = train_both(jcfg, tcfg, data)
    tol = TOL[(arch, optimizer)]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    assert losses[-1][1] < losses[0][1]
    tp = tsteps.param_leaves(tp)
    faults, noise = param_faults(tol, jp0, jp, tp, grads)
    assert faults == [] and noise <= NOISE_SHARE, (faults, noise)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    moved = 0
    for i, (a0, a) in enumerate(zip(jax.tree.leaves(jp0),
                                    jax.tree.leaves(jp))):
        if np.array_equal(np.asarray(a0), np.asarray(a)):
            continue        # the loss does not reach it: nothing to plant
        planted = tp[:i] + [torch.tensor(np.array(a0))] + tp[i + 1:]
        assert param_faults(tol, jp0, jp, planted, grads)[0] == [paths[i]]
        moved += 1
    assert moved >= len(paths) - 3


# ---------------------------------------------------------------------------
# the gradient each step hands its optimizer, through a stub optimizer
# ---------------------------------------------------------------------------

def stub_optimizers(monkeypatch):
    """Make both packages' ``make_opt`` return an optimizer whose update
    returns (reference) or writes into the parameters (port) the
    gradients it was given."""
    monkeypatch.setattr(jsteps, "make_opt", lambda cfg: jopt.Optimizer(
        lambda p: {}, lambda g, s, p, step: (g, s)))

    def update(grads, state, params, step, donate=False):
        for p, g in zip(params, grads):
            p.copy_(g)
        return params, state
    monkeypatch.setattr(tsteps, "make_opt", lambda cfg: topt.Optimizer(
        lambda p: {}, update))


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def port_grads(tcfg, tp, batch):
    """(the gradients the port's step hands its optimizer, the loss)."""
    out = tsteps.make_train_step(tcfg)(clone(tp), {}, 0, batch)
    return out[0], float(out[3]["loss"])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_accumulated_gradients_match_reference(arch, optimizer,
                                               monkeypatch):
    """2 microbatches: the gradients summed in float32 (AdamW) or bfloat16
    (Adafactor) and divided by 2, and the mean loss, against the
    reference's.  In bfloat16 each microbatch's gradient is rounded before
    the sum, and where the two packages' float32 gradients straddle a
    rounding boundary the sum differs by an ulp of that summand, which
    can be large against a sum that cancels: the tolerance adds one
    bfloat16 ulp (2^-7) of each microbatch's gradient, read from the
    reference's one-microbatch steps on the two halves."""
    stub_optimizers(monkeypatch)
    jcfg, tcfg = configs(arch, optimizer=optimizer, train_microbatches=2)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    b = batches(tcfg, 1)[0]

    def reference(cfg, batch):
        g, _, _, m = jax.jit(jsteps.make_train_step(cfg))(
            jp, {}, jnp.int32(0), jax.tree.map(jnp.asarray, batch))
        return jax.tree.leaves(g), float(m["loss"])

    jg, jloss = reference(jcfg, b)
    halves = [reference(dataclasses.replace(jcfg, train_microbatches=1),
                        {k: v[h * B // 2:(h + 1) * B // 2]
                         for k, v in b.items()})[0] for h in (0, 1)]
    tg, loss = port_grads(tcfg, tp, b)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    accum = jnp.float32 if optimizer == "adamw" else jnp.bfloat16
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    for path, a, t, g1, g2 in zip(paths, jg, tsteps.param_leaves(tg),
                                  *halves):
        assert a.dtype == accum
        a = np.asarray(a, np.float32).astype(np.float64)
        t = to_np(t).astype(np.float64)
        tol = GRAD_TOL[arch] * rms(a)
        if optimizer == "adafactor":
            tol = tol + 2.0 ** -7 * (np.abs(np.asarray(g1)) +
                                     np.abs(np.asarray(g2)))
        assert (np.abs(a - t) <= tol).all(), path


# bfloat16 params, the full configs' path: (arch, compute dtype) -> (loss
# rtol, r of each leaf's difference against the reference's movement).
# Read over 1 and 2 microbatches: 1.0e-4 / 0.081 (phi4, bf16 compute),
# 1.5e-3 / 0.51 (rwkv, bf16 compute: its conditioning, above, in bf16),
# 4.1e-6 / 0.037 (rwkv, float32 compute)
BF16_TOL = {("phi4-mini-3.8b", "bfloat16"): (3e-4, 0.25),
            ("rwkv6-3b", "bfloat16"): (5e-3, 0.75),
            ("rwkv6-3b", "float32"): (2e-5, 0.15)}


@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("arch,compute", list(BF16_TOL))
def test_train_step_bf16_params_match_reference(arch, compute, n_mb):
    """bfloat16 params and gradients, AdamW, 3 steps: with one microbatch
    the step hands AdamW the bfloat16 gradients, with two their float32
    sum.  Each loss within the tolerance of the reference's and moving the
    same way from step to step (RWKV-6's rises at the third step in
    both), the params bfloat16, and each leaf's difference from the
    reference's within ``r`` of the reference's movement (a leaf left
    alone reads 1)."""
    jcfg, tcfg = configs(arch, param_dtype="bfloat16", compute_dtype=compute,
                         train_microbatches=n_mb)
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    jp, tp, losses = train_both(jcfg, tcfg, batches(tcfg))
    loss_tol, r = BF16_TOL[(arch, compute)]
    for a, b in losses:
        assert abs(a - b) <= loss_tol * abs(a), losses
    ref, port = np.array(losses).T
    assert (np.sign(np.diff(ref)) == np.sign(np.diff(port))).all(), losses
    for (path, a), a0, b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                jax.tree.leaves(jp0),
                                tsteps.param_leaves(tp)):
        assert b.dtype == torch.bfloat16
        a, a0 = (np.asarray(x, np.float32).astype(np.float64)
                 for x in (a, a0))
        b = to_np(b.float()).astype(np.float64)
        assert rms(a - b) <= r * rms(a - a0), jax.tree_util.keystr(path)


# 10 AdamW steps on bf16 params and compute, the loss of each step against
# the reference's, relative: read 2.3e-4 (phi4-mini) and 2.9e-3 (RWKV-6,
# its bf16 conditioning, above), 4x and 3.5x allowed
LOSS_CURVE_STEPS = 10
LOSS_CURVE_TOL = {"phi4-mini-3.8b": 1e-3, "rwkv6-3b": 1e-2}


@pytest.mark.parametrize("arch", sorted(LOSS_CURVE_TOL))
def test_bf16_loss_curve_matches_reference(arch):
    """The full configs' setting at reduced widths: bf16 params and compute,
    ``make_opt``'s AdamW at lr 1e-4 with no warmup, 10 steps from the same
    params in both packages, each step's loss within LOSS_CURVE_TOL of the
    reference's.  Neither package's loss rises over the run (6.26 -> 5.25
    phi4-mini, 6.28 -> 5.81 RWKV-6, read), though single steps rise on a
    harder batch (phi4-mini at steps 4 and 8 in both)."""
    jcfg, tcfg = configs(arch, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    _, _, losses = train_both(jcfg, tcfg, batches(tcfg, LOSS_CURVE_STEPS))
    ref, port = np.array(losses).T
    assert (np.abs(ref - port) <= LOSS_CURVE_TOL[arch] * np.abs(ref)).all(), \
        losses
    assert ref[-1] < ref[0] and port[-1] < port[0], losses


def test_bf16_embedding_gradient_microbatch_gap(monkeypatch):
    """phi4-mini reduced with bfloat16 params and compute, one batch of 4 x
    1024 tokens (its most frequent token 2079 times): the embedding's
    gradient of 4 microbatches differs from 1's by ~0.23 rel-RMS in the
    reference as in the port (0.2336 and 0.2332 read), every other leaf by
    ~2e-3.  The embedding's gradient sums each token's repeats into a
    bfloat16 table, so the larger the microbatch the more those sums
    round.  At 1 and at 4 microbatches the packages' gradients are within
    1e-2 of each other at every leaf (read: 3.9e-3 at worst)."""
    stub_optimizers(monkeypatch)
    grads = {}
    for n_mb in (1, 4):
        jcfg, tcfg = configs("phi4-mini-3.8b", param_dtype="bfloat16",
                             compute_dtype="bfloat16",
                             train_microbatches=n_mb)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.model_params_from_jax(
            tcfg, jax.tree.map(np.asarray, jp), "cpu")
        b = batches(tcfg, 1, batch=4, seq=1024)[0]
        jg = jax.jit(jsteps.make_train_step(jcfg))(
            jp, {}, jnp.int32(0), jax.tree.map(jnp.asarray, b))[0]
        grads[n_mb] = (
            [np.asarray(x, np.float32).astype(np.float64)
             for x in jax.tree.leaves(jg)],
            [to_np(x.float()).astype(np.float64)
             for x in tsteps.param_leaves(port_grads(tcfg, tp, b)[0])])
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    gap = lambda x, y: rms(x - y) / rms(x)
    for n_mb in (1, 4):
        for path, a, t in zip(paths, *grads[n_mb]):
            assert gap(a, t) <= 1e-2, (n_mb, path)
    e = paths.index("['embed']")
    ref_gap = gap(grads[4][0][e], grads[1][0][e])
    port_gap = gap(grads[4][1][e], grads[1][1][e])
    assert ref_gap > 0.1 and abs(port_gap - ref_gap) <= 0.1 * ref_gap, (
        ref_gap, port_gap)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_remat_full_gradients_bit_equal(arch, monkeypatch):
    """``remat="full"`` recomputes each block in the backward: the
    gradients equal ``remat=""``'s bit for bit."""
    stub_optimizers(monkeypatch)
    b = batches(tbase.get_config(arch).reduced(), 1)[0]
    out = {}
    for remat in ("full", ""):
        _, tcfg = configs(arch, remat=remat, train_microbatches=2)
        tp = tmodel.init_params(tcfg, seed=0, device="cpu")
        out[remat] = tsteps.param_leaves(port_grads(tcfg, tp, b)[0])
    assert all(torch.equal(a, c) for a, c in zip(out["full"], out[""]))


def test_remat_checkpoints_each_block(monkeypatch):
    """With grad enabled and ``remat="full"`` every block runs under
    ``torch.utils.checkpoint``; under no_grad, or with ``""``, none does."""
    seen = []
    real = tmodel.checkpoint
    monkeypatch.setattr(tmodel, "checkpoint",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    _, tcfg = configs("phi4-mini-3.8b", remat="full")
    tp = tmodel.init_params(tcfg, seed=0, device="cpu")
    tok = torch.as_tensor(batches(tcfg, 1)[0]["tokens"])
    for p in tsteps.param_leaves(tp):
        p.requires_grad_(True)
    tmodel.forward_train(tcfg, tp, tok)
    assert len(seen) == tcfg.num_layers
    with torch.no_grad():
        tmodel.forward_train(tcfg, tp, tok)
    tmodel.forward_train(dataclasses.replace(tcfg, remat="dots"), tp, tok)
    assert len(seen) == tcfg.num_layers


# ---------------------------------------------------------------------------
# the microbatch clamp (the reference's tests/test_launch.py cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("requested,batch,n_dp,expected", [
    (8, 4, 1, 4), (16, 256, 32, 8), (4, 6, 1, 2), (4, 5, 1, 1),
    (2, 8, 1, 2), (1, 8, 1, 1)])
def test_microbatch_clamp_cases(requested, batch, n_dp, expected):
    assert tsteps.microbatches(requested, batch, n_dp) == expected


def test_microbatch_clamp():
    """B=4 < 8 microbatches clamps to 4; the loss is finite and the
    reference's."""
    jcfg, tcfg = configs("phi4-mini-3.8b", train_microbatches=8)
    _, _, losses = train_both(jcfg, tcfg, batches(tcfg, 1, batch=4, seq=16))
    (a, b), = losses
    assert np.isfinite(b) and abs(a - b) <= 1e-5 * abs(a)


# ---------------------------------------------------------------------------
# the refusals: no gradient through a kernel
# ---------------------------------------------------------------------------

def test_make_train_step_refuses_pallas():
    cfg = tbase.get_config("phi4-mini-3.8b").reduced()
    with pytest.raises(NotImplementedError,
                       match="cannot differentiate its Pallas kernels"):
        tsteps.make_train_step(cfg, backend="pallas")
    with pytest.raises(ValueError, match="unknown model backend"):
        tsteps.make_train_step(cfg, backend="triton")


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_backward_through_a_kernel_raises(arch):
    """``forward_train(backend="pallas")`` on parameters that require grad
    raises before any backward; under no_grad, or on parameters that do
    not require grad, it runs and equals the plain twin's forward."""
    cfg = tbase.get_config(arch).reduced()
    tp = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.as_tensor(batches(cfg, 1)[0]["tokens"])
    ref, _ = tmodel.forward_train(cfg, tp, tok)
    out, _ = tmodel.forward_train(cfg, tp, tok, backend="pallas")
    assert torch.allclose(out, ref, atol=1e-4)
    for p in tsteps.param_leaves(tp):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tmodel.forward_train(cfg, tp, tok, backend="pallas")
    with torch.no_grad():
        tmodel.forward_train(cfg, tp, tok, backend="pallas")


def test_kernel_entry_points_refuse_grad():
    """Each wrapper and its ``_cuda`` entry point refuse a grad-requiring
    input before anything else, so a CPU run refuses as a card run does."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rwkv6 import ops as wops
    q = torch.randn(1, 128, 2, 32, requires_grad=True)
    k = torch.randn(1, 128, 1, 32)
    for fn in (fops.flash_attention, fops.flash_attention_cuda,
               fops.flash_attention_bf16_cuda, fops.flash_attention_fp32_cuda):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(q, k, k)
    r = torch.randn(1, 16, 2, 16)
    w = torch.rand(1, 16, 2, 16, requires_grad=True)
    u, s0 = torch.randn(2, 16), torch.zeros(1, 2, 16, 16)
    for fn in (wops.wkv6, wops.wkv6_cuda):
        with pytest.raises(RuntimeError, match="forward only"):
            fn(r, r, r, w, u, s0)
    with torch.no_grad():
        wops.wkv6(r, r, r, w, u, s0)
        fops.flash_attention(q, k, k)


# ---------------------------------------------------------------------------
# abstract params and the roofline's device half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_model_flops_and_param_count(name):
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    jshape = jsteps.abstract_params(jcfg)
    tshape = tsteps.abstract_params(tcfg)
    assert all(t.is_meta for t in tsteps.param_leaves(tshape))
    assert troof.param_count(tcfg, tshape) == jroof.param_count(jcfg,
                                                                jshape)
    assert troof.active_param_count(tcfg, tshape) == \
        jroof.active_param_count(jcfg, jshape)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert troof.model_flops(tcfg, tbase.INPUT_SHAPES[shape], tshape) \
            == jroof.model_flops(jcfg, jbase.INPUT_SHAPES[shape], jshape)


def test_hardware_presets(monkeypatch):
    monkeypatch.delenv(troof.HW_SPEC_ENV, raising=False)
    for name in ("tpu_v5e", "cpu_generic"):
        assert troof.HARDWARE_PRESETS[name].to_dict() == \
            jroof.HARDWARE_PRESETS[name].to_dict()
    h100 = troof.hardware_spec("h100_sxm")
    assert (h100.peak_flops, h100.hbm_bw) == (989e12, 3.35e12)
    assert troof.hardware_spec(device="cpu").name == "cpu_generic"
    spec = troof.HardwareSpec("x", 1.0, 2.0, 3.0)
    assert troof.hardware_spec(spec) is spec
    monkeypatch.setenv(troof.HW_SPEC_ENV, "tpu_v5e")
    assert troof.hardware_spec(device="cpu").name == "tpu_v5e"


def test_hardware_spec_unknown_raises(monkeypatch):
    monkeypatch.delenv(troof.HW_SPEC_ENV, raising=False)
    with pytest.raises(ValueError, match="unknown hardware spec 'a100'.*"
                                         "h100_sxm"):
        troof.hardware_spec("a100")
    with pytest.raises(ValueError, match="no hardware preset for device "
                                         "'meta'.*cpu_generic"):
        troof.hardware_spec(device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no hardware preset"):
            troof.hardware_spec(device="cuda")


def test_opt_state_from_jax_layouts():
    for optimizer, keys in (("adamw", None), ("adafactor", "factored")):
        jcfg, tcfg = configs("phi4-mini-3.8b", optimizer=optimizer)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        js = jax.tree.map(np.asarray, jsteps.make_opt(jcfg).init(jp))
        ts = convert.opt_state_from_jax(tcfg, js, "cpu")
        leaves = tsteps.param_leaves(tmodel.init_params(tcfg, device="cpu"))
        if optimizer == "adamw":
            assert [t.shape for t in ts["m"]] == [p.shape for p in leaves]
            assert len(ts["v"]) == len(leaves)
        else:
            assert len(ts) == len(leaves)
            for s, p in zip(ts, leaves):
                assert set(s) == ({"vr", "vc"} if p.dim() >= 2 and
                                  min(p.shape[-2:]) >= 128 else {"v"})


# ---------------------------------------------------------------------------
# bfloat16 checkpoints and the cross-read
# ---------------------------------------------------------------------------

def bf16_tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
            "b": {"x": torch.randn(3, generator=g).to(torch.bfloat16),
                  "f": np.arange(4, dtype=np.float32)}}


def test_bf16_checkpoint_round_trip(tmp_path):
    tree = bf16_tree()
    p = str(tmp_path / "a.ckpt")
    ck.save(p, tree, step=3)
    arrays, manifest = ck.restore(p)
    assert manifest["arrays"]["w"]["dtype"] == "bfloat16"
    bits = tree["w"].view(torch.int16).numpy().view(np.uint16)
    assert manifest["arrays"]["w"]["crc32"] == zlib.crc32(bits.tobytes())
    assert arrays["w"].dtype == torch.bfloat16
    assert torch.equal(arrays["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    out = ck.restore(p, tree)
    assert torch.equal(out["b/x"], tree["b"]["x"])
    assert out["b/f"].dtype == np.float32
    with pytest.raises(ck.CheckpointError, match="has dtype bfloat16, "
                                                 "target wants float32"):
        ck.restore(p, {**tree, "w": torch.zeros(5, 7)})
    cast = ck.restore(p, {**tree, "w": torch.zeros(5, 7)}, cast=True)
    assert np.array_equal(cast["w"], tree["w"].float().numpy())
    up = ck.restore(p, {**tree, "b": {"x": tree["b"]["x"],
                                      "f": torch.zeros(4).bfloat16()}},
                    cast=True)
    assert up["b/f"].dtype == torch.bfloat16
    assert ck.validate(p, deep=True)["step"] == 3
    with ck.AsyncCheckpointer(str(tmp_path / "async")) as c:
        c.save(1, tree)
    back, _ = ck.restore(ck.latest_checkpoint(str(tmp_path / "async")))
    assert torch.equal(back["w"], tree["w"])


def test_float_checkpoint_bytes_unchanged(tmp_path):
    """A checkpoint of the dtypes the DRL path saves is byte for byte the
    layout it had: magic, the JSON manifest with numpy's dtype names,
    then each leaf's zlib stream, keys sorted."""
    tree = {"params": {"w": torch.randn(4, 3), "i": torch.arange(5)},
            "h": np.linspace(0, 1, 6), "step": 7}
    p = tmp_path / "drl.ckpt"
    ck.save(str(p), tree, step=7, metadata={"seed": 0})
    leaves = {"h": np.linspace(0, 1, 6), "params/i": np.arange(5),
              "params/w": tree["params"]["w"].numpy(),
              "step": np.asarray(7)}
    manifest = {"step": 7, "metadata": {"seed": 0},
                "arrays": {k: {"shape": list(leaves[k].shape),
                               "dtype": str(leaves[k].dtype),
                               "crc32": zlib.crc32(leaves[k].tobytes())}
                           for k in ("params/w", "params/i", "h", "step")},
                "compressed": True}
    mb = json.dumps(manifest).encode()
    want = ck.MAGIC + len(mb).to_bytes(8, "little") + mb
    for k in sorted(leaves):
        z = zlib.compress(leaves[k].tobytes(), ck.ZLIB_LEVEL)
        want += len(z).to_bytes(8, "little") + z
    assert p.read_bytes() == want


def test_bf16_cross_read_port_to_reference(tmp_path):
    tree = bf16_tree()
    p = str(tmp_path / "ref_format.ckpt")
    ck.save_reference(p, tree, step=5, metadata={"from": "port"})
    arrays, manifest = jck.restore(p)
    assert manifest["step"] == 5 and manifest["metadata"] == {"from": "port"}
    assert arrays["w"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(arrays["w"].view(np.uint16),
                          tree["w"].view(torch.int16).numpy().view(np.uint16))
    target = {"w": jnp.zeros((5, 7), jnp.bfloat16),
              "b": {"x": jnp.zeros(3, jnp.bfloat16),
                    "f": jnp.zeros(4, jnp.float32)}}
    back = jck.restore(p, target)
    assert back["w"].dtype == jnp.bfloat16
    # the same tree through each package's own format: the same entries
    ck.save(str(tmp_path / "own.ckpt"), tree, step=5)
    assert ck.read_manifest(str(tmp_path / "own.ckpt"))["arrays"] == \
        manifest["arrays"]


def test_bf16_cross_read_reference_to_port(tmp_path):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16)
    tree = {"w": w, "f": jnp.arange(3, dtype=jnp.float32)}
    p = str(tmp_path / "ref.ckpt")
    jck.save(p, tree, step=2, compress=False)
    out = ck.restore_reference(p, {"w": torch.zeros(6, 4).bfloat16(),
                                   "f": np.zeros(3, np.float32)})
    assert out["w"].dtype == torch.bfloat16
    assert np.array_equal(out["w"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(w).view(np.uint16))
    assert np.array_equal(out["w"].float().numpy(), np.asarray(w, np.float32))
    z = str(tmp_path / "ref_zstd.ckpt")
    jck.save(z, tree)
    if jck.read_manifest(z)["compressed"]:
        with pytest.raises(ck.CheckpointError, match="zstd"):
            ck.restore_reference(z)
    with pytest.raises(ck.CheckpointError, match="JAX package"):
        ck.restore(p)


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

def run_module(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=timeout, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    return out.stdout


def test_launch_train_script(tmp_path):
    out = run_module("repro_torch.launch.train", "--arch", "phi4-mini-3.8b",
                     "--reduced", "--steps", "5", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path))
    lines = out.splitlines()
    assert lines[0].startswith("init phi4-mini-3.8b-reduced: L=2")
    assert lines[1].startswith("params: ")
    assert sum(ln.startswith("step ") for ln in lines) == 5
    final = [ln for ln in lines if ln.startswith("final loss")][0]
    last, first = float(final.split()[2]), float(final.split()[4][:-1])
    assert last < first
    path = tmp_path / "step_00000005.ckpt"
    assert f"checkpoint -> {path}" in out
    arrays, manifest = ck.restore(str(path))
    assert manifest["step"] == 5
    assert "params/embed" in arrays


def test_quickstart_script():
    out = run_module("repro_torch.examples.quickstart", "--device", "cpu",
                     "--steps", "6")
    assert "greedy continuation:" in out
    assert out.splitlines()[-1] == "OK"
