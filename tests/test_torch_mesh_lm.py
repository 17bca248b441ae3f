"""The language model under a mesh: the port's single-controller mesh
branches against the reference's mesh path.

The reference runs under its own ``make_debug_mesh(1, 1)`` on the one CPU
device (the mesh its CLI trainer takes), the port under its
``make_debug_mesh(1, 1, device="cpu")``; parameters come over through
``convert`` at ``reduced()`` widths, float32.  Under a mesh both packages
compute the embedding lookup as a one-hot matmul, a decode's cache write
as a masked write (nothing written at ``pos >= S``) and its attention as
the einsum / float32 softmax chain.  The constraints each package places
are compared call by call on a (2, 4) abstract mesh, the reference's
``with_sharding_constraint`` replaced by a recorder.  Tolerances are the
mesh-less parity's: logits within ``test_torch_lm.LOGIT_ATOL``, losses
within its ``LOSS_ATOL``, caches within ``test_torch_serve``'s, the train
step at ``test_torch_lm_train.TOL``.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import act_sharding as jact
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import act_sharding as tact
from repro_torch.models import model as tmodel
from repro_torch.optim import optimizers as topt
from tests._torch_parity import assert_close, max_diff
from tests.test_torch_lm import LOGIT_ATOL, LOSS_ATOL
from tests.test_torch_lm_train import (STEPS, TOL, batches, clone,
                                       param_faults)
from tests.test_torch_serve import _hold_cache, _port_cache

JMESH = jmesh.make_debug_mesh(1, 1)
TMESH = tmesh.make_debug_mesh(1, 1, device="cpu")


def cfgs(name, **changes):
    return (dataclasses.replace(jbase.get_config(name).reduced(), **changes),
            dataclasses.replace(tbase.get_config(name).reduced(), **changes))


def params(cfg_j, cfg_t, seed=0):
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(seed))
    return jp, convert.model_params_from_jax(
        cfg_t, jax.tree.map(np.asarray, jp), device="cpu")


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def ref(fn, *args):
    """The reference's ``fn(*args)`` jitted under its debug mesh."""
    def run(*a):
        with jact.activation_mesh(JMESH):
            return fn(*a)
    return jax.jit(run)(*args)


def port(fn, *args, mesh=TMESH, **kw):
    with tact.activation_mesh(mesh):
        return fn(*args, **kw)


# ---------------------------------------------------------------------------
# the one-hot lookup
# ---------------------------------------------------------------------------

def test_lookup_is_a_one_hot_matmul_under_a_mesh():
    """The rows are the gather's, bit for bit; the embedding's gradient is
    the reference's mesh gradient (a matmul, one-hot^T @ dh) within
    float32 rounding, and without a mesh the port gathers (no one-hot:
    the recorder sees nothing)."""
    cfg_j, cfg_t = cfgs("phi4-mini-3.8b")
    jp, tp = params(cfg_j, cfg_t)
    toks = tokens(cfg_j, (2, 16), 1)
    w = np.random.default_rng(2).standard_normal(
        (2, 16, cfg_j.d_model)).astype(np.float32)
    gather = tmodel._lookup(cfg_t, tp, torch.tensor(toks))
    with tact.record_constraints() as log:
        assert tmodel._lookup(cfg_t, tp, torch.tensor(toks)) is not None
    assert log == []
    emb = tp["embed"].clone().requires_grad_(True)
    with tact.record_constraints() as log:
        rows = port(tmodel._lookup, cfg_t, {"embed": emb}, torch.tensor(toks))
    assert torch.equal(rows.detach(), gather)
    assert log[0][0] == (2, 16, cfg_t.vocab_padded)
    (g,) = torch.autograd.grad((rows * torch.tensor(w)).sum(), [emb])
    jg = jax.grad(lambda e: ref(lambda e: jnp.sum(jmodel._lookup(
        cfg_j, e, jnp.asarray(toks)) * w), e))(jp["embed"])
    assert max_diff(jg, g)[0] <= 1e-5


# ---------------------------------------------------------------------------
# forward, loss, prefill and decode
# ---------------------------------------------------------------------------

FORWARD = ("phi4-mini-3.8b", "rwkv6-3b", "hymba-1.5b", "deepseek-v3-671b")


@pytest.mark.parametrize("name", FORWARD)
def test_lm_loss_matches_reference_under_mesh(name):
    """``forward_train`` logits and ``lm_loss`` (loss and aux) under the
    debug mesh: dense, RWKV-6, the hybrid and MLA with its MoE and MTP
    head."""
    cfg_j, cfg_t = cfgs(name)
    jp, tp = params(cfg_j, cfg_t)
    toks, labels = tokens(cfg_j, (2, 32), 3), tokens(cfg_j, (2, 32), 4)
    batch = {"tokens": toks, "labels": labels}
    lj, aj = ref(lambda p, t: jmodel.forward_train(cfg_j, p, t), jp,
                 jnp.asarray(toks))
    with torch.no_grad():
        lt, at = port(tmodel.forward_train, cfg_t, tp, torch.tensor(toks))
        loss_t, parts = port(tmodel.lm_loss, cfg_t, tp,
                             {k: torch.tensor(v) for k, v in batch.items()})
    assert_close(lj, lt, LOGIT_ATOL, f"{name} logits")
    assert abs(float(aj) - float(at)) <= LOSS_ATOL
    loss_j, parts_j = ref(lambda p, b: jmodel.lm_loss(cfg_j, p, b), jp,
                          jax.tree.map(jnp.asarray, batch))
    assert abs(float(loss_j) - float(loss_t)) <= LOSS_ATOL
    assert abs(float(parts_j["loss"]) - float(parts["loss"])) <= LOSS_ATOL


# (name, changes, prompt S, cache_len): decode runs 4 steps from S, the
# last two at pos >= cache_len, where the reference's masked write writes
# nothing
DECODE = {"dense": ("phi4-mini-3.8b", {"num_kv_heads": 2}, 16, 18),
          "mla": ("deepseek-v3-671b", {}, 16, 18),
          "hybrid": ("hymba-1.5b", {}, 16, 18),
          "moe": ("phi3.5-moe-42b-a6.6b", {}, 16, 18)}


@pytest.mark.parametrize("case", sorted(DECODE))
def test_prefill_and_decode_match_reference_under_mesh(case):
    """Prefill under the mesh (logits and every cache leaf), then 4
    decode steps from the reference's prefilled cache: the logits and the
    cache after each.  At ``pos >= cache_len`` the port's K/V (or latent)
    cache is bit-equal to what it was, as the reference's is."""
    name, changes, S, cache_len = DECODE[case]
    cfg_j, cfg_t = cfgs(name, **changes)
    jp, tp = params(cfg_j, cfg_t)
    toks = tokens(cfg_j, (2, S), 5)
    logits_j, cache_j = ref(lambda p, t: jmodel.prefill(
        cfg_j, p, t, cache_len=cache_len), jp, jnp.asarray(toks))
    with torch.no_grad():
        logits, cache = port(tmodel.prefill, cfg_t, tp, torch.tensor(toks),
                             cache_len=cache_len)
    assert_close(logits_j, logits, LOGIT_ATOL, "prefill logits")
    _hold_cache(cache_j, cache, "prefill")
    cache_t = _port_cache(cfg_t, cache_j)
    serve = tsteps.make_serve_step(cfg_t, TMESH)
    steps_tok = tokens(cfg_j, (2, 4), 6)
    kv = "c_kv" if "c_kv" in cache_t else "k"
    for t in range(4):
        pos = S + t
        tok = steps_tok[:, t:t + 1]
        logits_j, cache_j = ref(lambda p, c, tk, ps: jmodel.decode_step(
            cfg_j, p, c, tk, ps), jp, cache_j, jnp.asarray(tok),
            jnp.int32(pos))
        before = cache_t[kv].clone()
        with torch.no_grad():
            logits, out = serve(tp, cache_t, torch.tensor(tok),
                                torch.tensor(pos))
        assert out is cache_t
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        _hold_cache(cache_j, cache_t, f"decode {t}")
        if pos >= cache_len:
            assert torch.equal(cache_t[kv], before), pos
        else:
            changed = (cache_t[kv] != before).any(dim=(0, 1, 3)) if kv == \
                "c_kv" else (cache_t[kv] != before).any(dim=(0, 1, 3, 4))
            assert changed.nonzero().flatten().tolist() == [pos]


def test_mesh_less_decode_still_clamps():
    """Without a mesh a write past the end still overwrites the last slot
    (the reference's clamped ``dynamic_update_slice``)."""
    cfg_j, cfg_t = cfgs("phi4-mini-3.8b")
    _, tp = params(cfg_j, cfg_t)
    cache = tmodel.init_cache(cfg_t, 1, 4, device="cpu")
    with torch.no_grad():
        tmodel.decode_step(cfg_t, tp, cache, torch.tensor([[3]]), 9)
    assert cache["k"][:, :, 3].any() and not cache["k"][:, :, :3].any()


# ---------------------------------------------------------------------------
# the constraints, call by call, on a (2, 4) abstract mesh
# ---------------------------------------------------------------------------

def unique(log):
    """The distinct constraints in the order of their first use."""
    return list(dict.fromkeys(log))


def reference_constraints(monkeypatch, fn, *args):
    """The (shape, spec) of each of the reference's sharding constraints
    in ``fn(*args)``, run eagerly under a (2, 4) abstract mesh."""
    log = []

    def record(x, sharding):
        log.append((tuple(x.shape), tuple(sharding.spec)))
        return x
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", record)
    with jact.activation_mesh(jmesh.make_abstract_mesh(
            (2, 4), ("data", "model"))):
        fn(*args)
    return log


@pytest.mark.parametrize("name,what", [
    ("phi4-mini-3.8b", "loss"), ("rwkv6-3b", "loss"),
    ("rwkv6-3b", "prefill"), ("hymba-1.5b", "decode"),
    ("deepseek-v3-671b", "decode"), ("phi4-mini-3.8b", "decode")])
def test_constraints_match_reference(name, what, monkeypatch):
    """The constraints the reference places (its ``constrain`` calls, its
    decode's cache pins), each distinct (shape, spec) in the order of its
    first use, on a (2, 4) mesh.  The reference traces a scan's body once
    and the port runs it per layer, so the port records at least as many;
    its ``constrain`` returns its input."""
    cfg_j, cfg_t = cfgs(name)
    jp, tp = params(cfg_j, cfg_t)
    toks, labels = tokens(cfg_j, (4, 16), 7), tokens(cfg_j, (4, 16), 8)
    if what == "loss":
        fn_j = lambda: jmodel.lm_loss(cfg_j, jp, {"tokens": toks,
                                                  "labels": labels})
        fn_t = lambda: tmodel.lm_loss(cfg_t, tp, {
            "tokens": torch.tensor(toks), "labels": torch.tensor(labels)})
    elif what == "prefill":
        fn_j = lambda: jmodel.prefill(cfg_j, jp, jnp.asarray(toks))
        fn_t = lambda: tmodel.prefill(cfg_t, tp, torch.tensor(toks))
    else:
        cache_j = jmodel.init_cache(cfg_j, 4, 16)
        cache_t = _port_cache(cfg_t, cache_j)
        cache_t = {k: cache_t[k] for k in cache_j}     # the same key order
        fn_j = lambda: jmodel.decode_step(cfg_j, jp, cache_j,
                                          jnp.asarray(toks[:, :1]),
                                          jnp.int32(3))
        fn_t = lambda: tmodel.decode_step(cfg_t, tp, cache_t,
                                          torch.tensor(toks[:, :1]), 3)
    want = reference_constraints(monkeypatch, fn_j)
    with torch.no_grad(), tact.record_constraints() as got:
        port(fn_t, mesh=tmesh.make_abstract_mesh((2, 4),
                                                 ("data", "model")))
    got = [(s, tuple(p)) for s, p in got]
    assert len(got) >= len(want) > 0
    assert unique(got) == unique(want)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def stub_reference_opt():
    return jopt.Optimizer(lambda p: {}, lambda g, s, p, step: (g, s))


def test_train_step_matches_reference_under_mesh(monkeypatch):
    """3 AdamW steps of reduced phi4-mini under the debug mesh, 2
    microbatches, against the reference's jitted ``make_train_step(cfg,
    mesh)``: losses and params at ``test_torch_lm_train``'s tolerances
    (its noise floor read from the reference's first-step mesh
    gradients)."""
    jcfg, tcfg = cfgs("phi4-mini-3.8b", train_microbatches=2)
    data = batches(tcfg)
    jp0, tp = params(jcfg, tcfg)
    with monkeypatch.context() as m:
        m.setattr(jsteps, "make_opt", lambda cfg: stub_reference_opt())
        g_ref = jax.jit(jsteps.make_train_step(jcfg, JMESH))(
            jp0, {}, jnp.int32(0), jax.tree.map(jnp.asarray, data[0]))[0]
    g_ref = [np.asarray(x, np.float64) for x in jax.tree.leaves(g_ref)]
    js = jsteps.make_opt(jcfg).init(jp0)
    ts = convert.opt_state_from_jax(tcfg, jax.tree.map(np.asarray, js),
                                    "cpu")
    jfn = jax.jit(jsteps.make_train_step(jcfg, JMESH))
    tfn = tsteps.make_train_step(tcfg, TMESH)
    jp, jstep, tstep, losses = jp0, jnp.int32(0), 0, []
    for b in data:
        jp, js, jstep, jm = jfn(jp, js, jstep, jax.tree.map(jnp.asarray, b))
        tp, ts, tstep, tm = tfn(tp, ts, tstep, b)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    assert tstep == STEPS == len(data)
    tol = TOL[("phi4-mini-3.8b", "adamw")]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    faults, _ = param_faults(tol, jp0, jp, tsteps.param_leaves(tp), g_ref)
    assert faults == []


def test_train_step_gradients_match_reference_under_mesh(monkeypatch):
    """The accumulated gradients of one step under the mesh: the
    embedding's comes from the one-hot matmul in both packages."""
    monkeypatch.setattr(jsteps, "make_opt",
                        lambda cfg: stub_reference_opt())

    def update(grads, state, params, step, donate=False):
        for p, g in zip(params, grads):
            p.copy_(g)
        return params, state
    monkeypatch.setattr(tsteps, "make_opt", lambda cfg: topt.Optimizer(
        lambda p: {}, update))
    jcfg, tcfg = cfgs("phi4-mini-3.8b", train_microbatches=2)
    jp, tp = params(jcfg, tcfg)
    b = batches(tcfg, 1)[0]
    gj = jax.jit(jsteps.make_train_step(jcfg, JMESH))(
        jp, {}, jnp.int32(0), jax.tree.map(jnp.asarray, b))[0]
    gt = tsteps.make_train_step(tcfg, TMESH)(clone(tp), {}, 0, b)[0]
    for (path, a), t in zip(jax.tree_util.tree_flatten_with_path(gj)[0],
                            tsteps.param_leaves(gt)):
        a = np.asarray(a, np.float64)
        scale = float(np.sqrt(np.mean(a * a)))
        assert max_diff(a, t)[0] <= 1e-4 * scale, \
            jax.tree_util.keystr(path)


def test_microbatch_clamp_by_the_data_parallel_width(monkeypatch):
    """Under a (2, 1) mesh a batch of 4 asked for 4 microbatches runs 2
    (each microbatch must divide the 2 dp ways), each of 2 sequences; with
    no mesh, 4 of one."""
    monkeypatch.setattr(tsteps, "make_opt", lambda cfg: topt.Optimizer(
        lambda p: {}, lambda g, s, p, step, donate=False: (p, s)))
    seen = []
    real = tmodel.lm_loss

    def lm_loss(cfg, params, batch, **kw):
        seen.append(batch["tokens"].shape[0])
        return real(cfg, params, batch, **kw)
    monkeypatch.setattr(tmodel, "lm_loss", lm_loss)
    _, tcfg = cfgs("phi4-mini-3.8b", train_microbatches=4)
    tp = tmodel.init_params(tcfg, seed=1, device="cpu")
    b = batches(tcfg, 1)[0]
    tsteps.make_train_step(tcfg, tmesh.make_abstract_mesh(
        (2, 1), ("data", "model")))(tp, {}, 0, b)
    assert seen == [2, 2]
    seen.clear()
    tsteps.make_train_step(tcfg)(tp, {}, 0, b)
    assert seen == [1, 1, 1, 1]
    assert tsteps.microbatches(4, 4, 2) == 2


# ---------------------------------------------------------------------------
# the CLI trainer
# ---------------------------------------------------------------------------

def test_launch_train_matches_reference_cli(monkeypatch):
    """``python -m repro_torch.launch.train`` and the reference's CLI, both
    in process, from the same parameters (the reference's
    ``init_params(PRNGKey(0))`` handed to the port's script): both build
    their step under the debug mesh, and each step's loss (read from the
    steps' metrics) agrees within ``test_torch_lm_train.TOL``'s 1e-5
    relative."""
    argv = ["--arch", "phi4-mini-3.8b", "--reduced", "--steps", "4"]
    cfg_j = jbase.get_config("phi4-mini-3.8b").reduced()
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    want, got, made = [], [], []
    real_jit, real_make = jax.jit, tsteps.make_train_step

    def jit(fn, *a, **kw):
        step = real_jit(fn, *a, **kw)

        def run(*args):
            out = step(*args)
            want.append(float(out[3]["loss"]))
            return out
        return run

    def make(cfg, mesh=None, **kw):
        made.append(mesh)
        step = real_make(cfg, mesh, **kw)

        def run(*args):
            out = step(*args)
            got.append(float(out[3]["loss"]))
            return out
        return run

    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["train"] + argv)
        m.setattr(jax, "jit", jit)
        with contextlib.redirect_stdout(io.StringIO()):
            jtrain.main()
    real_init = tmodel.init_params
    monkeypatch.setattr(tmodel, "init_params",
                        lambda cfg, seed=0, device="cuda":
                        real_init(cfg, seed, device) if str(device) == "meta"
                        else convert.model_params_from_jax(
                            cfg, jax.tree.map(np.asarray, jp), device))
    monkeypatch.setattr(tsteps, "make_train_step", make)
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.main(argv + ["--device", "cpu"])
    assert len(made) == 1 and dict(made[0].shape) == {"data": 1, "model": 1}
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert abs(a - b) <= 1e-5 * abs(a), (want, got)
