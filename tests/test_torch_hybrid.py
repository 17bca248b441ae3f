"""Parity of the port's hybrid family with the reference: the Mamba selective
SSM (``init_mamba``, ``_causal_conv``, ``apply_mamba``, ``mamba_scan`` and
its step-by-step oracle), ``models/hybrid.py``, and ``hymba-1.5b`` through
``forward_train``, ``lm_loss``, ``init_cache``, ``prefill``,
``decode_step`` and ``make_train_step``, at ``reduced()`` sizes (2 layers,
D 256, 4 heads of 64, a window of 64, a Mamba state of 8).

The same numpy-seeded inputs go through both packages; the reference's
parameters come over through ``convert.model_params_from_jax``, its caches
through ``convert.cache_from_jax``.  Everything is float32 unless a test
says otherwise.  Tolerances:

* ``apply_mamba``'s output within 1e-5 of its RMS and its SSM state within
  1e-6 absolute (O(1) states): the doubling scan multiplies the same
  float32 factors in another order, a few ulp apart;
* the model's logits within 1e-5 of their RMS and ``test_torch_lm``'s
  LOGIT_ATOL, the loss within its LOSS_ATOL, the caches within
  ``test_torch_serve``'s CACHE_ATOL (the SSM state within 1e-6 absolute);
* the train step at ``test_torch_lm_train``'s tolerance for phi4-mini
  under AdamW, whose helpers it runs, and the first step's gradients leaf
  by leaf within GRAD_TOL of each leaf's RMS.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import hybrid as jhyb
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import hybrid as thyb
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from tests import test_torch_lm_train as lmt
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_lm import LOGIT_ATOL, LOSS_ATOL
from tests.test_torch_serve import CACHE_ATOL, CONSISTENCY_GATE

NAME = "hymba-1.5b"
MAMBA_REL, STATE_ATOL = 1e-5, 1e-6
LOGIT_REL = 1e-5
# read: apply_mamba's output 1.2e-7 to 5.5e-7 of its RMS, its state 4.8e-7
# absolute at worst (states up to 3.6); the logits 8.5e-7 of their RMS
# the first train step's gradients, each leaf's max |port - reference|
# over its RMS (read: 2.5e-5 at worst, the embedding and w_dt; 1e-6 to
# 1.3e-5 elsewhere)
GRAD_TOL = 1e-4
# a bf16 forward at reduced width against the reference's, rel-RMS of the
# logits (read: 1.07e-2 and 1.16e-2 for the two backends; phi4-mini's
# reduced bf16 forward reads 9.4e-3 likewise): the reference rounds its
# bf16 matmuls and elementwise chains in XLA's fused order, which may keep
# float32 between ops (the conv's four taps, the norms), the port op by
# op, and two layers of such bf16 roundings (2^-9 relative each) add up to
# ~1% of the logits' RMS
BF16_LOGIT_REL = 3e-2


def configs(**changes):
    return (dataclasses.replace(jbase.get_config(NAME).reduced(), **changes),
            dataclasses.replace(tbase.get_config(NAME).reduced(), **changes))


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


def rel_rms(ref, out):
    a = to_np(ref).astype(np.float64)
    b = to_np(out).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))


def mamba_params(cfg_j, seed=0, **changes):
    """The reference's Mamba parameters at the reduced hybrid's width
    (d_inner = H dh = 256), and the port's copy; ``changes`` replace
    leaves by constants."""
    di = cfg_j.num_heads * cfg_j.resolved_head_dim
    p = jssm.init_mamba(cfg_j, jax.random.PRNGKey(seed), d_inner=di)
    p = {k: jnp.full_like(v, changes[k]) if k in changes else v
         for k, v in p.items()}
    return p, tree_to_torch(jax.tree.map(np.asarray, p))


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """hymba-1.5b, full and reduced, field by field: window 1024, GQA 25 /
    5 of dh 64, a Mamba state of 16."""
    ref, out = jbase.get_config(NAME), tbase.get_config(NAME)
    assert dataclasses.asdict(ref) == dataclasses.asdict(out)
    assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(
        out.reduced())
    assert (out.sliding_window, out.num_heads, out.num_kv_heads,
            out.resolved_head_dim, out.ssm.kind) == (1024, 25, 5, 64, "mamba")


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_init_params_matches_reference_shapes(which):
    """The reduced config (bf16 params, on the CPU) and the full one (on
    "meta"): the same paths, shapes and dtypes as ``jax.eval_shape`` of the
    reference's; ``A_log`` and ``Dskip`` float32, ``A_log`` the
    reference's log 1..n within one float32 ulp (torch's log 7 is the
    correctly rounded 1.9459101, XLA's one ulp above), ``dt_bias`` -4,
    ``conv_b`` 0."""
    if which == "reduced":
        cfg_j, cfg_t = configs(param_dtype="bfloat16")
        device = "cpu"
    else:
        cfg_j, cfg_t = jbase.get_config(NAME), tbase.get_config(NAME)
        device = "meta"
    ref = jax.eval_shape(lambda: jmodel.init_params(cfg_j,
                                                    jax.random.PRNGKey(0)))
    out = tmodel.init_params(cfg_t, seed=1, device=device)
    rl = jax.tree_util.tree_leaves_with_path(ref)
    ol = jax.tree_util.tree_leaves_with_path(out)
    assert [k for k, _ in rl] == [k for k, _ in ol]
    for (k, r), (_, o) in zip(rl, ol):
        assert tuple(r.shape) == tuple(o.shape), k
        assert o.dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
    m = out["blocks"]["hyb"]["mamba"]
    assert m["A_log"].dtype == m["Dskip"].dtype == torch.float32
    if device == "cpu":
        jm = jssm.init_mamba(cfg_j, jax.random.PRNGKey(0), d_inner=256)
        assert_close(jm["A_log"], m["A_log"][0], 2.0 ** -22, "A_log")
        assert bool((m["dt_bias"] == -4).all() and (m["conv_b"] == 0).all()
                    and (m["Dskip"] == 1).all())
        assert out["blocks"]["hyb"]["out_norm_ssm"].dtype == torch.bfloat16


def test_model_flops_and_param_count():
    """The full config's count, 1,404,264,000 parameters, and its model
    FLOPs equal to the reference's (d_inner 1600, dt_rank 100)."""
    jcfg, tcfg = jbase.get_config(NAME), tbase.get_config(NAME)
    jshape, tshape = (jsteps.abstract_params(jcfg),
                      tsteps.abstract_params(tcfg))
    assert troof.param_count(tcfg, tshape) == jroof.param_count(
        jcfg, jshape) == 1_404_264_000
    assert tshape["blocks"]["hyb"]["mamba"]["w_dt"].shape == (32, 100, 1600)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert troof.model_flops(tcfg, tbase.INPUT_SHAPES[shape], tshape) \
            == jroof.model_flops(jcfg, jbase.INPUT_SHAPES[shape], jshape)


def test_model_params_from_jax_keeps_the_float32_leaves():
    """A bf16 reference tree: every leaf arrives with its bits, ``A_log``
    and ``Dskip`` as float32 beside bf16 weights."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        cfg_j, jax.random.PRNGKey(3)))
    assert tree["blocks"]["hyb"]["mamba"]["w_in"].dtype == ml_dtypes.bfloat16
    tp = convert.model_params_from_jax(cfg_t, tree, device="cpu")
    m = tp["blocks"]["hyb"]["mamba"]
    assert m["A_log"].dtype == m["Dskip"].dtype == torch.float32
    assert m["w_in"].dtype == torch.bfloat16
    for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(tp)):
        assert np.array_equal(np.asarray(a, np.float32), t.float().numpy()), \
            path


# ---------------------------------------------------------------------------
# the Mamba layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,state", [(2, False), (2, True), (9, False),
                                     (9, True)])
def test_causal_conv_matches_reference(S, state):
    """The four taps in the reference's order and the new conv state, the
    last 3 rows of [state; x]: with a 2-token input those rows hold one
    row of the old state (zeros without one).  1e-6 on O(1) values."""
    W, di = 4, 16
    x, w, b = rand((2, S, di), 1), rand((W, di), 2), rand((di,), 3)
    cs = rand((2, W - 1, di), 4) if state else None
    ry, rs = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if cs is None else jnp.asarray(cs))
    oy, os_ = tssm._causal_conv(torch.tensor(x), torch.tensor(w),
                                torch.tensor(b),
                                None if cs is None else torch.tensor(cs))
    assert_close(ry, oy, 1e-6, "conv out")
    assert np.array_equal(np.asarray(rs), to_np(os_))
    if S == 2:
        assert np.array_equal(to_np(os_)[:, 1:], x)
        assert np.array_equal(to_np(os_)[:, :1],
                              cs[:, 2:] if state else np.zeros((2, 1, di)))


MAMBA_CASES = [(S, state) for S in (1, 7, 64, 128, 200)
               for state in (False, True)]


def hold_mamba(cfg_j, cfg_t, jp, tp, S, state, seed):
    x = rand((2, S, cfg_t.d_model), seed)
    di = tp["Dskip"].shape[0]
    cs = rand((2, 3, di), seed + 1) if state else None
    hs = rand((2, di, cfg_t.ssm.state_size), seed + 2) if state else None
    ref = jssm.apply_mamba(cfg_j, jp, jnp.asarray(x),
                           None if cs is None else jnp.asarray(cs),
                           None if hs is None else jnp.asarray(hs))
    out = tssm.apply_mamba(cfg_t, tp, torch.tensor(x),
                           None if cs is None else torch.tensor(cs),
                           None if hs is None else torch.tensor(hs))
    err = rel_rms(ref[0], out[0])
    assert err <= MAMBA_REL, err
    assert_close(ref[1], out[1], CACHE_ATOL, "conv state")
    assert_close(ref[2], out[2], STATE_ATOL, "ssm state")
    assert out[2].dtype == torch.float32
    return ref, out


@pytest.mark.parametrize("S,state", MAMBA_CASES)
def test_apply_mamba_matches_reference(S, state):
    """Zero and carried conv / SSM states; S 1 (decode), 7 and 64 (the
    reference's step-by-step scan), 128 (its chunked scan under remat), 200
    (step by step again; the port pads the last of 4 chunks)."""
    cfg_j, cfg_t = configs()
    jp, tp = mamba_params(cfg_j)
    hold_mamba(cfg_j, cfg_t, jp, tp, S, state, 10 + S)


def test_apply_mamba_through_underflowing_decays():
    """dt_bias raised to +2: dt ~ 2, exp(dt A) down to ~1e-7 at A = -8,
    so the products of a few steps' decays underflow to 0 in float32 in
    both packages' orders; the output and state still agree."""
    cfg_j, cfg_t = configs()
    jp, tp = mamba_params(cfg_j, dt_bias=2.0)
    ref, _ = hold_mamba(cfg_j, cfg_t, jp, tp, 128, True, 40)
    x = jnp.asarray(rand((2, 128, cfg_t.d_model), 40))
    di = tp["Dskip"].shape[0]
    xz = x @ jp["w_in"]
    xi = jax.nn.silu(jssm._causal_conv(xz[..., :di], jp["conv_w"],
                                       jp["conv_b"])[0])
    dt = jax.nn.softplus(xi @ jp["w_bcdt"][:, 16:] @ jp["w_dt"] + 2.0)
    decay = np.asarray(jnp.exp(dt[..., None] * -jnp.exp(jp["A_log"])))
    assert decay.min() < 1e-6 and np.prod(decay[:, :8], 1).min() == 0.0


@pytest.mark.parametrize("S,chunk", [(1, 64), (7, 64), (64, 64), (65, 64),
                                     (200, 64), (256, 64), (100, 8),
                                     (37, 4)])
def test_mamba_scan_matches_sequential(S, chunk):
    """The two-level doubling scan against the step-by-step oracle on
    decays in (0.5, 1) and O(1) inputs from a carried state: y and the
    last state within 1e-6 of their scale (float32, another order of the
    same products); chunks of 8 and 4 put several levels on both scans."""
    B, di, n = 2, 6, 5
    rng = np.random.default_rng(S)
    dA = torch.tensor(rng.uniform(0.5, 1.0, (B, S, di, n)), dtype=torch.float32)
    dBx, C, h0 = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                  for s in ((B, S, di, n), (B, S, n), (B, di, n)))
    y, h = tssm.mamba_scan(dA, dBx, C, h0, chunk=chunk)
    ry, rh = tssm.mamba_scan_sequential(dA, dBx, C, h0)
    assert y.shape == (B, S, di) and h.shape == (B, di, n)
    assert max_diff(ry, y)[0] <= 1e-6 * float(ry.abs().max())
    assert max_diff(rh, h)[0] <= 1e-6 * float(rh.abs().max())


def test_mamba_scan_gradients_match_sequential():
    """Autograd through the doubling scan (float64) against autograd
    through the oracle: the gradients of every input within 1e-10."""
    B, S, di, n = 1, 37, 3, 2
    rng = np.random.default_rng(7)
    ins = [torch.tensor(rng.uniform(0.5, 1.0, (B, S, di, n))),
           torch.tensor(rng.standard_normal((B, S, di, n))),
           torch.tensor(rng.standard_normal((B, S, n))),
           torch.tensor(rng.standard_normal((B, di, n)))]
    wy = torch.tensor(rng.standard_normal((B, S, di)))
    wh = torch.tensor(rng.standard_normal((B, di, n)))
    grads = []
    for fn in (lambda *a: tssm.mamba_scan(*a, chunk=8),
               tssm.mamba_scan_sequential):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        y, h = fn(*leaves)
        grads.append(torch.autograd.grad((y * wy).sum() + (h * wh).sum(),
                                         leaves))
    for a, b in zip(*grads):
        assert max_diff(b, a)[0] <= 1e-10


class OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_mamba_launches_grow_with_log_s():
    """The operations of one ``apply_mamba`` at a narrow width (D 16, d_inner
    16, n 4), counted as dispatched: at S 4096 under twice those at S 256
    (the scan's levels grow with log2 S), while the step-by-step oracle's
    grow with S."""
    cfg = dataclasses.replace(tbase.get_config(NAME).reduced(), d_model=16,
                              ssm=tbase.SSMConfig(kind="mamba", state_size=4))
    p = tssm.init_mamba(cfg, torch.Generator().manual_seed(0), d_inner=16)
    counts = {}
    for S in (256, 4096):
        x = torch.tensor(rand((1, S, 16), S))
        with torch.no_grad(), OpCount() as c:
            out, _, _ = tssm.apply_mamba(cfg, p, x)
        counts[S] = c.n
        assert out.shape == (1, S, 16)
        z = torch.zeros((1, S, 2, 2))
        with OpCount() as c:
            tssm.mamba_scan_sequential(z, z, z[..., 0], z[:, 0])
        counts[("oracle", S)] = c.n
    assert counts[4096] < 2 * counts[256], counts
    assert counts[("oracle", 4096)] > 10 * counts[("oracle", 256)], counts


# ---------------------------------------------------------------------------
# the hybrid block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_apply_hybrid_matches_reference(backend):
    """Both branches, normed and averaged, at S 100 past the window of 64;
    "pallas" runs the flash kernel's plain twin here (the reference's own
    kernel in interpret mode): 1e-5 of the output's RMS."""
    cfg_j, cfg_t = configs()
    p = jhyb.init_hybrid(cfg_j, jax.random.PRNGKey(4))
    tp = tree_to_torch(jax.tree.map(np.asarray, p))
    x = rand((2, 100, cfg_t.d_model), 5)
    pos = np.broadcast_to(np.arange(100, dtype=np.int32), (2, 100))
    ref = jhyb.apply_hybrid(cfg_j, p, jnp.asarray(x), jnp.asarray(pos),
                            backend=backend)
    out = thyb.apply_hybrid(cfg_t, tp, torch.tensor(x), torch.tensor(pos),
                            backend=backend)
    assert rel_rms(ref, out) <= MAMBA_REL


def test_decode_hybrid_matches_reference():
    """One token against K / V and Mamba states: the output, the K / V
    written at the position, the new conv and SSM states."""
    cfg_j, cfg_t = configs()
    p = jhyb.init_hybrid(cfg_j, jax.random.PRNGKey(6))
    tp = tree_to_torch(jax.tree.map(np.asarray, p))
    di, n = 256, cfg_t.ssm.state_size
    x = rand((2, 1, cfg_t.d_model), 7)
    k, v = (rand((2, 80, 4, 64), s) for s in (8, 9))
    cs, hs = rand((2, 3, di), 10), rand((2, di, n), 11)
    ref = jhyb.decode_hybrid(cfg_j, p, jnp.asarray(x), jnp.asarray(k),
                             jnp.asarray(v), jnp.asarray(cs), jnp.asarray(hs),
                             jnp.int32(70))
    out = thyb.decode_hybrid(cfg_t, tp, torch.tensor(x), torch.tensor(k),
                             torch.tensor(v), torch.tensor(cs),
                             torch.tensor(hs), torch.tensor(70))
    assert rel_rms(ref[0], out[0]) <= MAMBA_REL
    for r, o in zip(ref[1:4], out[1:4]):
        assert_close(r, o, CACHE_ATOL)
    assert_close(ref[4], out[4], STATE_ATOL, "ssm state")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_case():
    cfg_j, cfg_t = configs()
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(32)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 96)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, 96)).astype(np.int32)
    return cfg_j, cfg_t, jp, tp, toks, labels


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(model_case, backend):
    """Logits at S 96 (past the window) within 1e-5 of their RMS and
    LOGIT_ATOL; the aux is 0."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                        backend=backend)
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                    backend=backend)
    assert out.shape == (2, 96, cfg_t.vocab_padded)
    assert rel_rms(ref, out) <= LOGIT_REL
    assert_close(ref, out, LOGIT_ATOL, f"{backend} logits")
    assert float(aux) == float(aux_ref) == 0.0


def test_lm_loss_matches_reference(model_case):
    """The loss, plain and masked."""
    cfg_j, cfg_t, jp, tp, toks, labels = model_case
    mask = np.zeros(toks.shape, np.float32)
    mask[:, 40:] = 1.0
    for m in (None, mask):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.tensor(m)
        ref, _ = jmodel.lm_loss(cfg_j, jp, jb)
        out, _ = tmodel.lm_loss(cfg_t, tp, tb)
        assert abs(float(ref) - float(out)) <= LOSS_ATOL


def hold_cache(ref, out, what):
    """Every leaf: its shape and dtype; K, V and the conv state within
    CACHE_ATOL, the SSM state within STATE_ATOL."""
    assert sorted(ref) == sorted(out) == ["conv", "k", "ssm", "v"], what
    for k in ref:
        assert tuple(np.shape(ref[k])) == tuple(out[k].shape), (what, k)
        assert np.dtype(ref[k].dtype).name == str(out[k].dtype).split(".")[1]
        assert_close(np.asarray(ref[k], np.float32), out[k].float(),
                     STATE_ATOL if k == "ssm" else CACHE_ATOL, f"{what} {k}")


@pytest.mark.parametrize("which", ["reduced", "full"])
def test_init_cache_matches_reference(which):
    """Shapes and dtypes against ``jax.eval_shape``: K / V and the conv
    state in the cache dtype (bf16 at full size), the SSM state float32;
    at full size one 4096-position sequence is 171.4 MB (K and V 83.9 MB
    each, the conv state 0.31 MB, the SSM state 3.28 MB)."""
    if which == "reduced":
        cfg_j, cfg_t = configs()
    else:
        cfg_j, cfg_t = jbase.get_config(NAME), tbase.get_config(NAME)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 1, 4096))
    out = tmodel.init_cache(cfg_t, 1, 4096, device="cpu")
    if which == "full":
        assert sum(t.numel() * t.element_size() for t in out.values()) \
            == 171_356_160
        assert out["conv"].dtype == torch.bfloat16
    assert sorted(ref) == sorted(out)
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(out[k].shape), k
        assert out[k].dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
    assert out["ssm"].dtype == torch.float32


@pytest.mark.parametrize("cache_len", [100, 80])
def test_prefill_matches_reference(model_case, cache_len):
    """Prefill of S 96 into a cache longer (zeros after) and shorter
    (truncated) than the prompt: the next-token logits and every cache
    leaf; the conv and SSM states are those after the whole prompt."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    logits_j, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks),
                                       cache_len=cache_len)
    logits, cache = tmodel.prefill(cfg_t, tp, torch.tensor(toks),
                                   cache_len=cache_len)
    assert rel_rms(logits_j, logits) <= LOGIT_REL
    assert_close(logits_j, logits, LOGIT_ATOL, "prefill logits")
    hold_cache(cache_j, cache, "prefill")


def test_decode_matches_reference(model_case):
    """Prefill of 62, then 6 decode steps from the reference's prefilled
    cache (``cache_from_jax``) over positions 62-67, past the window of
    64: the logits and every cache leaf after each step, updated in
    place."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    _, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks[:, :62]),
                                cache_len=72)
    cache_t = convert.cache_from_jax(cfg_t, jax.tree.map(np.asarray, cache_j),
                                     device="cpu")
    assert cache_t["ssm"].dtype == torch.float32
    for t in range(6):
        tok = toks[:, 62 + t:63 + t]
        logits_j, cache_j = jmodel.decode_step(
            cfg_j, jp, cache_j, jnp.asarray(tok), jnp.int32(62 + t))
        logits, out = tmodel.decode_step(cfg_t, tp, cache_t,
                                         torch.tensor(tok), 62 + t)
        assert out is cache_t
        assert rel_rms(logits_j, logits) <= LOGIT_REL
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        hold_cache(cache_j, cache_t, f"decode {t}")


def test_cache_from_jax_keeps_the_ssm_state_float32():
    """A bf16 reference cache: K, V and the conv state arrive as bf16 with
    their bits, the SSM state as float32."""
    cfg_j, cfg_t = configs(compute_dtype="bfloat16")
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(2))
    toks = np.random.default_rng(2).integers(0, 512, (1, 9)).astype(np.int32)
    _, cache = jmodel.prefill(cfg_j, jp, jnp.asarray(toks))
    tree = jax.tree.map(np.asarray, cache)
    out = convert.cache_from_jax(cfg_t, tree, device="cpu")
    for k, a in tree.items():
        want = torch.float32 if k == "ssm" else torch.bfloat16
        assert out[k].dtype == want, k
        assert np.array_equal(a.astype(np.float32), out[k].float().numpy())


def test_prefill_decode_consistency():
    """The twin of tests/test_arch_smoke.py's test_prefill_decode_
    consistency for hymba on the port alone: prefill of S - 1 tokens, a
    decode of the last, against the forward's logits at S - 1 within the
    reference's 0.05 of their scale; here S 80, past the window."""
    _, cfg = configs()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    S = 80
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)))
    full, _ = tmodel.forward_train(cfg, params, toks)
    _, cache = tmodel.prefill(cfg, params, toks[:, :S - 1], cache_len=S + 2)
    logits, _ = tmodel.decode_step(cfg, params, cache, toks[:, S - 1:],
                                   S - 1)
    ref = full[:, S - 1]
    err = float((logits - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < CONSISTENCY_GATE


def test_serving_steps_take_the_hybrid_config():
    """``make_prefill_step`` and ``make_serve_step`` on the reduced config:
    finite logits, the Mamba leaves moved by the decode."""
    _, cfg = configs()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    logits, cache = tsteps.make_prefill_step(cfg)(params, toks)
    before = cache["ssm"].clone()
    again, _ = tsteps.make_serve_step(cfg)(params, cache, toks[:, :1], 7)
    assert torch.isfinite(logits).all() and torch.isfinite(again).all()
    assert not torch.equal(before, cache["ssm"])


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_bf16_forward_matches_reference(backend):
    """bf16 params and compute at reduced width, S 80: the logits within
    BF16_LOGIT_REL of their RMS (see its note)."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(1))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, (2, 80)).astype(np.int32)
    ref, _ = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                  backend=backend)
    out, _ = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                  backend=backend)
    assert rel_rms(np.asarray(ref, np.float32), out) <= BF16_LOGIT_REL


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_matches_reference(monkeypatch):
    """The first step's gradients, leaf by leaf within GRAD_TOL of the
    leaf's RMS (through both packages' stub optimizers), then 3 AdamW
    steps from the same params and state at ``test_torch_lm_train``'s
    tolerance for phi4-mini under AdamW: the losses, every element of
    every leaf, each leaf against the reference's movement."""
    jcfg, tcfg = configs()
    data = lmt.batches(tcfg)
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grads = lmt.reference_grads(jcfg, jp0, data[0], monkeypatch)
    tp0 = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp0),
                                        "cpu")
    with monkeypatch.context() as m:
        lmt.stub_optimizers(m)
        port, _ = lmt.port_grads(tcfg, tp0, data[0])
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp0)[0]]
    for path, g, o in zip(paths, grads, tsteps.param_leaves(port)):
        scale = lmt.rms(g)
        assert scale > 0, path
        assert max_diff(g, o)[0] <= GRAD_TOL * scale, path
    jp, tp, losses = lmt.train_both(jcfg, tcfg, data)
    tol = lmt.TOL[("phi4-mini-3.8b", "adamw")]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    faults, noise = lmt.param_faults(tol, jp0, jp, tsteps.param_leaves(tp),
                                     grads)
    assert faults == [] and noise <= lmt.NOISE_SHARE, (faults, noise)


def test_make_train_step_refuses_pallas_for_hymba():
    """Training runs the reference mixers: the pallas backend is refused
    when the step is built, as for every config."""
    _, cfg = configs()
    with pytest.raises(NotImplementedError,
                       match="cannot differentiate its Pallas kernels"):
        tsteps.make_train_step(cfg, backend="pallas")


def test_launch_train_script_runs_hymba():
    """``python -m repro_torch.launch.train --arch hymba-1.5b --reduced
    --steps 10`` on the CPU: the loss falls."""
    out = lmt.run_module("repro_torch.launch.train", "--arch", NAME,
                         "--reduced", "--steps", "10", "--device", "cpu")
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")][0]
    assert float(final.split()[2]) < float(final.split()[4][:-1])


def test_hybrid_with_another_ssm_is_refused():
    """A hybrid config whose ssm is absent or not mamba: "not ported" at
    every entry point that checks the config."""
    cfg = tbase.get_config(NAME).reduced()
    for ssm in (None, tbase.SSMConfig(kind="rwkv6")):
        bad = dataclasses.replace(cfg, ssm=ssm)
        for call in (lambda: tmodel.init_params(bad, device="cpu"),
                     lambda: tmodel.init_cache(bad, 1, 4, device="cpu"),
                     lambda: tsteps.make_train_step(bad)):
            with pytest.raises(NotImplementedError, match="not ported"):
                call()
