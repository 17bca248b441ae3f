"""Parity of the port's mixture of experts with the reference: the router,
the capacity, the sort-based dispatch with its drops, the token waves, the
shared experts and the dense-layer prefix (``models/moe.py``,
``models/model.py``), and ``phi3.5-moe-42b-a6.6b`` through ``forward_train``,
``lm_loss``, ``prefill``, ``decode_step`` and ``make_train_step``, at
``reduced()`` sizes.

The same numpy-seeded inputs go through both packages; the reference's
parameters come over through ``convert.model_params_from_jax``.  Everything
is float32 unless a test says otherwise.  The kept set of a dispatch
depends on which expert each token picks, so every parity test asserts the
two packages route alike, and that the smallest gap between a token's k-th
and (k+1)-th router probability is above :data:`MIN_GAP`, so that the
equality says something: a gap of float32 noise could flip an expert.
Tolerances:

* the router's probabilities and aux loss within 1e-6 (float32 softmax of
  O(1) logits, and a mean of them);
* a dispatch's O(1) outputs within 1e-5 (float32 products of another
  summation order); a token whose pair was dropped in one package and kept
  in the other would be off by O(1);
* the model's logits and loss within ``test_torch_lm``'s LOGIT_ATOL /
  LOSS_ATOL, the caches within ``test_torch_serve``'s; the train step at
  ``test_torch_lm_train``'s tolerance for phi4-mini under AdamW, whose
  helpers it runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from tests import test_torch_lm_train as lmt
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_lm import LOGIT_ATOL, LOSS_ATOL
from tests.test_torch_serve import (CONSISTENCY_GATE, _hold_cache,
                                    _port_cache)

NAME = "phi3.5-moe-42b-a6.6b"
# the smallest k-th / (k+1)-th router probability gap of a parity input.
# Through the whole model each package routes its own hidden states, whose
# router probabilities differ by up to 4.5e-7 here (float32 attention and
# norms of another summation order): a token's gap there must be above
# MIN_GAP_MODEL and 10x that difference
MIN_GAP, MIN_GAP_MODEL = 1e-4, 1e-5
ROUTER_TOL, DISPATCH_TOL = 1e-6, 1e-5
# a bf16 dispatch: (rel-RMS, max abs over the largest |value|), 2x and 4
# ulps against the readings (see the test)
BF16_DISPATCH_TOL = (1e-2, 2.0 ** -5)
# the variants of the reduced config the model tests run: plain (4
# experts, top 2, dropless at cf 8.0), with a shared expert and a dense
# first layer, and with drops (cf 1.0)
VARIANTS = {
    "plain": {},
    "shared-dense": {"num_shared_experts": 1, "first_dense_layers": 1},
    "drops": {"capacity_factor": 1.0},
}


def configs(moe=None, **changes):
    """The reference's and the port's reduced phi3.5, its ``MoEConfig``
    replaced by ``moe`` and the config by ``changes``."""
    out = []
    for base in (jbase, tbase):
        cfg = base.get_config(NAME).reduced()
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   **moe))
        out.append(dataclasses.replace(cfg, **changes))
    return tuple(out)


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


def moe_params(cfg_j, seed=0):
    p = jmoe.init_moe(cfg_j, jax.random.PRNGKey(seed))
    return p, tree_to_torch(jax.tree.map(np.asarray, p))


def min_gap(top_p_sorted_probs, k):
    """The smallest gap between each row's k-th and (k+1)-th largest."""
    s = -np.sort(-np.asarray(top_p_sorted_probs), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


def router_probs(cfg, p, xf):
    logits = np.asarray(xf, np.float32) @ np.asarray(p["w_router"])
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def reference_keep(cfg, top_idx, C):
    """The reference's dispatch order and kept pairs, by its own steps
    (``repro.models.moe._moe_dispatch``): a stable argsort of the flat
    expert ids, each pair's row within its expert, kept below C ->
    the sorted token-major flat indices of the kept pairs."""
    E = cfg.moe.num_experts
    flat_expert = jnp.asarray(top_idx).reshape(-1)
    order = jnp.argsort(flat_expert)
    e_s = flat_expert[order]
    counts = jnp.zeros((E,), jnp.int32).at[flat_expert].add(1)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(flat_expert.size, dtype=jnp.int32) - starts[e_s]
    return np.sort(np.asarray(order)[np.asarray(pos < C)]), np.asarray(
        counts)


# ---------------------------------------------------------------------------
# router, capacity, dispatch
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """The port's phi3.5 config, full and reduced (capacity_factor 8.0),
    field by field, registered beside the dense configs."""
    ref, out = jbase.get_config(NAME), tbase.get_config(NAME)
    assert dataclasses.asdict(ref) == dataclasses.asdict(out)
    assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(
        out.reduced())
    assert out.moe.impl == "shard_map"
    assert out.reduced().moe.capacity_factor == 8.0
    assert NAME in tbase.list_configs()


def test_router_matches_reference():
    """T 64: the same experts, their renormalised probabilities and the
    Switch aux loss within ROUTER_TOL."""
    cfg_j, cfg_t = configs()
    jp, tp = moe_params(cfg_j)
    xf = rand((64, cfg_j.d_model), 1)
    K = cfg_j.moe.top_k
    assert min_gap(router_probs(cfg_j, jp, xf), K) > MIN_GAP
    p_j, i_j, aux_j = jmoe.router(cfg_j, jp, jnp.asarray(xf))
    p_t, i_t, aux_t = tmoe.router(cfg_t, tp, torch.tensor(xf))
    assert np.array_equal(np.asarray(i_j), to_np(i_t))
    assert_close(p_j, p_t, ROUTER_TOL, "top_p")
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL
    assert float(aux_t) > 0.0


def test_router_ties_take_the_lower_expert():
    """Equal probabilities: the lower expert first, as ``jax.lax.top_k``
    orders them."""
    cfg_j, cfg_t = configs()
    E, D = cfg_t.moe.num_experts, cfg_t.d_model
    p = {"w_router": np.zeros((D, E), np.float32)}
    p["w_router"][0, 1] = p["w_router"][0, 3] = 1.0
    xf = np.zeros((3, D), np.float32)
    xf[:, 0] = (1.0, 0.0, -1.0)
    _, i_j, _ = jmoe.router(cfg_j, {"w_router": jnp.asarray(p["w_router"])},
                            jnp.asarray(xf))
    _, i_t, _ = tmoe.router(cfg_t, tree_to_torch(p), torch.tensor(xf))
    assert np.array_equal(np.asarray(i_j), to_np(i_t))
    assert to_np(i_t).tolist() == [[1, 3], [0, 1], [0, 2]]


@pytest.mark.parametrize("T", [1, 7, 64, 4096, 1 << 20])
def test_capacity_matches_reference(T):
    """Over K, E and the capacity factor: K T cf / E rounded up to a
    multiple of 8, at least 8."""
    for K, E, cf in [(1, 4, 1.0), (2, 16, 1.25), (2, 4, 8.0), (8, 256, 1.25),
                     (2, 16, 0.5), (6, 64, 2.0)]:
        moe = {"top_k": K, "num_experts": E, "capacity_factor": cf}
        cfg_j, cfg_t = configs(moe)
        c = tmoe._capacity(cfg_t, T)
        assert c == jmoe._capacity(cfg_j, T), (T, K, E, cf)
        assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_moe_dispatch_matches_reference(cf):
    """B 2 x S 32 tokens at capacity factors 8.0 (dropless), 1.0 and 0.5:
    the same pairs kept (the port's stable sort against the reference's
    argsort) and the outputs within DISPATCH_TOL.  At 0.5 an expert
    overflows."""
    cfg_j, cfg_t = configs({"capacity_factor": cf})
    jp, tp = moe_params(cfg_j, 2)
    x = rand((2, 32, cfg_j.d_model), 3)
    xf = x.reshape(-1, cfg_j.d_model)
    K, T = cfg_j.moe.top_k, xf.shape[0]
    assert min_gap(router_probs(cfg_j, jp, xf), K) > MIN_GAP
    C = tmoe._capacity(cfg_t, T)
    _, top_idx, _ = jmoe.router(cfg_j, jp, jnp.asarray(xf))
    kept_j, counts = reference_keep(cfg_j, top_idx, C)
    _, top_t, _ = tmoe.router(cfg_t, tp, torch.tensor(xf))
    order, _, _, keep = tmoe.dispatch_plan(cfg_t, top_t, C)
    kept_t = np.sort(to_np(order[keep]))
    assert np.array_equal(kept_j, kept_t)
    if cf == 8.0:
        assert kept_t.size == T * K
    if cf == 0.5:
        assert counts.max() > C and kept_t.size < T * K
    out_j, aux_j = jmoe._moe_dispatch(cfg_j, jp, jnp.asarray(x))
    out_t, aux_t = tmoe._moe_dispatch(cfg_t, tp, torch.tensor(x))
    assert_close(out_j, out_t, DISPATCH_TOL, f"cf {cf}")
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL


def test_dispatch_keeps_the_first_pairs_of_an_expert():
    """Every pair routed to one expert, capacity 8: the kept pairs are the
    first 8 by token-major flat index (t K + k), as the reference keeps
    them; an unstable sort could keep any 8."""
    _, cfg_t = configs()
    top_idx = torch.zeros((40, 2), dtype=torch.int64)
    top_idx[:, 1] = 1
    order, e_s, pos, keep = tmoe.dispatch_plan(cfg_t, top_idx, 8)
    assert to_np(order[keep]).tolist() == (list(range(0, 16, 2))
                                           + list(range(1, 17, 2)))
    assert to_np(e_s).tolist() == [0] * 40 + [1] * 40
    assert to_np(pos).tolist() == list(range(40)) * 2


def test_moe_dispatch_bfloat16_matches_reference():
    """bf16 params and compute at cf 1.0 (drops): the same experts (the
    float32 router), the outputs within BF16_DISPATCH_TOL.  The bf16
    products agree bit for bit on this CPU; ``jax.nn.silu`` of bf16 rounds
    its sigmoid to bf16 before the product, where torch's silu rounds
    once (58% of silu outputs bit-equal), and those one-ulp differences of
    the hidden rows carry through ``we2``: 40% of the outputs bit-equal,
    5.1e-3 rel-RMS and 2 ulps of the largest |value| at worst read."""
    cfg_j, cfg_t = configs({"capacity_factor": 1.0},
                           param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jmoe.init_moe(cfg_j, jax.random.PRNGKey(4))
    tp = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.float32 if k == "w_router" else torch.bfloat16)
        for k, v in jp.items()}
    assert np.asarray(jp["w_router"]).dtype == np.float32
    assert np.asarray(jp["we1"]).dtype == ml_dtypes.bfloat16
    x = rand((2, 32, cfg_j.d_model), 5)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    out_j, aux_j = jmoe._moe_dispatch(cfg_j, jp, jnp.asarray(xb))
    out_t, aux_t = tmoe._moe_dispatch(cfg_t, tp,
                                      torch.tensor(x).to(torch.bfloat16))
    assert out_t.dtype == torch.bfloat16
    _, i_j, _ = jmoe.router(cfg_j, jp, jnp.asarray(xb).reshape(64, -1))
    _, i_t, _ = tmoe.router(cfg_t, tp, torch.tensor(xb.astype(np.float32)
                                                   ).reshape(64, -1))
    assert np.array_equal(np.asarray(i_j), to_np(i_t))
    ref, out = np.asarray(out_j, np.float32), out_t.float().numpy()
    rel = float(np.sqrt(np.mean((ref - out) ** 2) / np.mean(ref ** 2)))
    worst = max_diff(ref, out)[0] / float(np.abs(ref).max())
    assert rel <= BF16_DISPATCH_TOL[0] and worst <= BF16_DISPATCH_TOL[1], (
        rel, worst)
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL


def waves_case(impl):
    cfg_j, cfg_t = configs({"impl": impl, "capacity_factor": 1.0})
    jp, tp = moe_params(cfg_j, 6)
    x = rand((2, 32, cfg_j.d_model), 7)
    assert min_gap(router_probs(cfg_j, jp, x.reshape(-1, cfg_j.d_model)),
                   cfg_j.moe.top_k) > MIN_GAP
    return cfg_j, cfg_t, jp, tp, x


def test_apply_moe_runs_token_waves(monkeypatch):
    """``impl="gspmd"`` with MOE_TOKEN_WAVE patched to 16 in both
    packages: 64 tokens at B 2 run as 4 waves of 8 positions, each with its
    own capacity (8, where the whole input has 32), and the mean of the
    waves' aux; the two packages agree, and the waves' output differs from
    one dispatch of the whole input (at cf 1.0 the waves drop other
    pairs), so the waves ran in both."""
    cfg_j, cfg_t, jp, tp, x = waves_case("gspmd")
    calls = []
    real = tmoe._moe_dispatch
    monkeypatch.setattr(tmoe, "_moe_dispatch",
                        lambda c, p, xs: calls.append(xs.shape) or
                        real(c, p, xs))
    monkeypatch.setattr(tmoe, "MOE_TOKEN_WAVE", 16)
    monkeypatch.setattr(jmoe, "MOE_TOKEN_WAVE", 16)
    out_j, aux_j = jmoe.apply_moe(cfg_j, jp, jnp.asarray(x))
    out_t, aux_t = tmoe.apply_moe(cfg_t, tp, torch.tensor(x))
    assert calls == [(2, 8, cfg_t.d_model)] * 4
    assert_close(out_j, out_t, DISPATCH_TOL, "waves")
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL
    whole, _ = real(cfg_t, tp, torch.tensor(x))
    assert max_diff(whole, out_t)[0] > 1e-2
    waves = [real(cfg_t, tp, torch.tensor(x[:, w:w + 8]))
             for w in range(0, 32, 8)]
    assert abs(float(aux_t) - float(torch.stack([a for _, a in waves]
                                                ).mean())) <= 1e-7


def test_apply_moe_shard_map_runs_no_waves(monkeypatch):
    """``impl="shard_map"`` (phi3.5's): without a mesh with a "model" axis
    the reference's expert-parallel path falls back to one dispatch of the
    whole input, with no waves, whatever MOE_TOKEN_WAVE is; so does the
    port's."""
    cfg_j, cfg_t, jp, tp, x = waves_case("shard_map")
    monkeypatch.setattr(tmoe, "MOE_TOKEN_WAVE", 16)
    monkeypatch.setattr(jmoe, "MOE_TOKEN_WAVE", 16)
    out_j, aux_j = jmoe.apply_moe(cfg_j, jp, jnp.asarray(x))
    out_t, aux_t = tmoe.apply_moe(cfg_t, tp, torch.tensor(x))
    whole_j, _ = jmoe._moe_dispatch(cfg_j, jp, jnp.asarray(x))
    whole_t, whole_aux = tmoe._moe_dispatch(cfg_t, tp, torch.tensor(x))
    assert np.array_equal(np.asarray(out_j), np.asarray(whole_j))
    assert torch.equal(out_t, whole_t) and torch.equal(aux_t, whole_aux)
    assert_close(out_j, out_t, DISPATCH_TOL, "shard_map")
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL


def test_shared_experts_match_reference():
    """One shared expert (F 128) added to the routed mix, at cf 0.5."""
    cfg_j, cfg_t = configs({"num_shared_experts": 1, "capacity_factor": 0.5})
    jp, tp = moe_params(cfg_j, 8)
    assert tuple(tp["shared"]["w1"].shape) == (cfg_t.d_model, 128)
    x = rand((2, 16, cfg_j.d_model), 9)
    assert min_gap(router_probs(cfg_j, jp, x.reshape(-1, cfg_j.d_model)),
                   cfg_j.moe.top_k) > MIN_GAP
    out_j, _ = jmoe.apply_moe(cfg_j, jp, jnp.asarray(x))
    out_t, _ = tmoe.apply_moe(cfg_t, tp, torch.tensor(x))
    assert_close(out_j, out_t, DISPATCH_TOL, "shared")
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    assert max_diff(out_t, tmoe.apply_moe(cfg_t, no_shared,
                                          torch.tensor(x))[0])[0] > 1e-2


def test_dropless_dispatch_is_the_dense_mix():
    """The twin of tests/test_substrates.py's dropless parity in the port:
    at cf 8.0 the dispatch equals every token's top-k experts run densely
    and mixed by their probabilities."""
    _, cfg_t = configs()
    _, tp = moe_params(configs()[0], 10)
    x = torch.tensor(rand((2, 8, cfg_t.d_model), 11))
    out, _ = tmoe.apply_moe(cfg_t, tp, x)
    xf = x.reshape(-1, cfg_t.d_model)
    top_p, top_idx, _ = tmoe.router(cfg_t, tp, xf)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xf, tp["we1"]))
    h = h * torch.einsum("td,edf->tef", xf, tp["we3"])
    every = torch.einsum("tef,efd->ted", h, tp["we2"])
    ref = sum(every[torch.arange(xf.shape[0]), top_idx[:, k]]
              * top_p[:, k:k + 1] for k in range(cfg_t.moe.top_k))
    assert_close(ref, out.reshape(-1, cfg_t.d_model), DISPATCH_TOL, "dense")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_params_matches_reference_shapes(variant):
    """The full config's and each reduced variant's tree (bf16 params):
    the same paths, shapes and dtypes as ``jax.eval_shape`` of the
    reference's, the router float32; ``blocks_dense`` holds the dense
    prefix.  The port's draws: the experts as ``dense_init`` draws them
    (a normal cut at +-2 over sqrt(fan-in))."""
    cfg_j, cfg_t = configs(VARIANTS[variant], param_dtype="bfloat16")
    full_j, full_t = jbase.get_config(NAME), tbase.get_config(NAME)
    for cj, ct, device in ((cfg_j, cfg_t, "cpu"), (full_j, full_t, "meta")):
        ref = jax.eval_shape(lambda: jmodel.init_params(
            cj, jax.random.PRNGKey(0)))
        out = tmodel.init_params(ct, seed=1, device=device)
        rl = jax.tree_util.tree_leaves_with_path(ref)
        ol = jax.tree_util.tree_leaves_with_path(out)
        assert [k for k, _ in rl] == [k for k, _ in ol]
        for (k, r), (_, o) in zip(rl, ol):
            assert tuple(r.shape) == tuple(o.shape), k
            assert o.dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
        assert out["blocks"]["moe"]["w_router"].dtype == torch.float32
        assert ("blocks_dense" in out) == bool(ct.moe.first_dense_layers)
    p = tmodel.init_params(cfg_t, seed=1, device="cpu")
    we2 = p["blocks"]["moe"]["we2"].float()           # fan-in F = 128
    assert float(we2.abs().max()) <= 2.0 / 128 ** 0.5 * (1 + 2 ** -8)
    assert abs(float(we2.std()) - 0.88 / 128 ** 0.5) < 3e-3
    assert len({float(w.std()) for w in we2.reshape(-1, 128, 256)}) > 1
    again = tmodel.init_params(cfg_t, seed=1, device="cpu")
    assert torch.equal(again["blocks"]["moe"]["we1"],
                       p["blocks"]["moe"]["we1"])


def test_model_params_from_jax_counts_both_stacks():
    """A dense prefix's layers count with ``blocks``' against
    ``num_layers``; the router keeps float32 beside bf16 experts."""
    cfg_j, cfg_t = configs(VARIANTS["shared-dense"], param_dtype="bfloat16",
                           num_layers=3)
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        cfg_j, jax.random.PRNGKey(0)))
    assert np.shape(tree["blocks"]["ln1"]["scale"])[0] == 2
    tp = convert.model_params_from_jax(cfg_t, tree, device="cpu")
    assert tp["blocks"]["moe"]["w_router"].dtype == torch.float32
    assert tp["blocks"]["moe"]["we1"].dtype == torch.bfloat16
    assert tp["blocks_dense"]["ffn"]["w1"].shape[0] == 1
    for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(tp)):
        assert np.array_equal(np.asarray(a, np.float32), t.float().numpy()), \
            path
    with pytest.raises(ValueError, match="3 stacked layers"):
        convert.model_params_from_jax(
            dataclasses.replace(cfg_t, num_layers=2), tree, device="cpu")


def test_model_flops_and_active_params():
    """The full config's abstract params: every count equal to the
    reference's, the experts counted at top_k / num_experts."""
    jcfg, tcfg = jbase.get_config(NAME), tbase.get_config(NAME)
    jshape, tshape = (jsteps.abstract_params(jcfg),
                      tsteps.abstract_params(tcfg))
    total = troof.param_count(tcfg, tshape)
    assert total == jroof.param_count(jcfg, jshape) == 41_874_100_224
    active = troof.active_param_count(tcfg, tshape)
    assert active == jroof.active_param_count(jcfg, jshape)
    experts = 3 * 32 * 16 * 4096 * 6400
    assert active == total - experts + experts * 2 // 16
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert troof.model_flops(tcfg, tbase.INPUT_SHAPES[shape], tshape) \
            == jroof.model_flops(jcfg, jbase.INPUT_SHAPES[shape], jshape)


# ---------------------------------------------------------------------------
# the model: forward, loss, serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model_case(request):
    cfg_j, cfg_t = configs(VARIANTS[request.param])
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(32)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    return cfg_j, cfg_t, jp, tp, toks, labels


def routing_agrees(cfg_j, cfg_t, jp, tp, toks):
    """Each MoE layer of both packages, each on its own hidden states (as
    the forward runs them): the same experts; -> (the smallest k-th /
    (k+1)-th probability gap, the largest difference of the two packages'
    router probabilities)."""
    hj = jmodel._embed(cfg_j, jp, jnp.asarray(toks))
    pos_j = jmodel._positions(cfg_j, jnp.asarray(toks))
    ht = tmodel._embed(cfg_t, tp, torch.tensor(toks))
    pos_t = tmodel._positions(cfg_t, torch.tensor(toks))
    gap, diff = np.inf, 0.0
    for name in [k for k in ("blocks_dense", "blocks") if k in jp]:
        for i in range(jp[name]["ln1"]["scale"].shape[0]):
            bp = jax.tree.map(lambda a: a[i], jp[name])
            tbp = tmodel.layer(tp[name], i)
            if "moe" in bp:
                mix, _ = jmodel._mixer(cfg_j, bp, hj, pos_j)
                xj = np.asarray(jmodel.apply_norm(cfg_j, bp["ln2"], hj + mix))
                xt = tmodel.apply_norm(cfg_t, tbp["ln2"], ht + tmodel._mixer(
                    cfg_t, tbp, ht, pos_t))
                xj, xt = (x.reshape(-1, cfg_t.d_model) for x in (xj, xt))
                _, i_j, _ = jmoe.router(cfg_j, bp["moe"], jnp.asarray(xj))
                _, i_t, _ = tmoe.router(cfg_t, tbp["moe"], xt)
                assert np.array_equal(np.asarray(i_j), to_np(i_t))
                probs = router_probs(cfg_j, bp["moe"], xj)
                gap = min(gap, min_gap(probs, cfg_j.moe.top_k))
                diff = max(diff, float(np.abs(probs - torch.softmax(
                    xt @ tbp["moe"]["w_router"], -1).numpy()).max()))
            (hj, _), _ = jmodel._block_body(cfg_j, (hj, jnp.float32(0.0)),
                                            bp, positions=pos_j)
            ht, _ = tmodel._block_body(cfg_t, ht, tbp, positions=pos_t)
    return gap, diff


def assert_routing_meaningful(case):
    """The two packages pick the same experts at every MoE layer, with
    every token's k-th / (k+1)-th gap above MIN_GAP_MODEL and 10x the two
    packages' probability difference (read: 4.5e-7 at most, gaps down to
    5.3e-5)."""
    cfg_j, cfg_t, jp, tp, toks, _ = case
    gap, diff = routing_agrees(cfg_j, cfg_t, jp, tp, toks)
    assert gap > MIN_GAP_MODEL and gap > 10 * diff, (gap, diff)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(model_case, backend):
    """Logits within LOGIT_ATOL and the aux (the routers' losses summed over
    the MoE layers) within ROUTER_TOL; the reference's pallas backend runs
    its flash kernel in interpret mode."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    assert_routing_meaningful(model_case)
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                        backend=backend)
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                    backend=backend)
    assert out.shape == (2, 32, cfg_t.vocab_padded)
    assert_close(ref, out, LOGIT_ATOL, f"{cfg_t.name} {backend} logits")
    assert float(aux_ref) > 0.0
    assert abs(float(aux) - float(aux_ref)) <= ROUTER_TOL


def test_lm_loss_matches_reference(model_case):
    """The loss plus aux, plain and masked, and its parts."""
    cfg_j, cfg_t, jp, tp, toks, labels = model_case
    mask = np.zeros(toks.shape, np.float32)
    mask[:, 16:] = 1.0
    for m in (None, mask):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.tensor(m)
        ref, parts_ref = jmodel.lm_loss(cfg_j, jp, jb)
        out, parts = tmodel.lm_loss(cfg_t, tp, tb)
        assert abs(float(ref) - float(out)) <= LOSS_ATOL
        assert abs(float(parts_ref["aux"]) - float(parts["aux"])) <= \
            ROUTER_TOL
        assert float(out) == pytest.approx(float(parts["loss"])
                                           + float(parts["aux"]), abs=1e-6)


def test_prefill_and_decode_match_reference(model_case):
    """Prefill of S 32 into a cache of 35 positions, then 4 decode steps
    from the reference's prefilled cache (``cache_from_jax``): the logits
    and every cache leaf after each step; the cache keeps one axis of
    ``num_layers`` over both stacks.  The fourth step writes past the end
    (clamped to the last slot in both)."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    logits_j, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks),
                                       cache_len=35)
    logits, cache = tmodel.prefill(cfg_t, tp, torch.tensor(toks),
                                   cache_len=35)
    assert_close(logits_j, logits, LOGIT_ATOL, "prefill logits")
    _hold_cache(cache_j, cache, "prefill")
    assert cache["k"].shape[0] == cfg_t.num_layers
    cache_t = _port_cache(cfg_t, cache_j)
    steps = np.random.default_rng(33).integers(
        0, cfg_j.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        tok = steps[:, t:t + 1]
        logits_j, cache_j = jmodel.decode_step(
            cfg_j, jp, cache_j, jnp.asarray(tok), jnp.int32(32 + t))
        logits, out = tmodel.decode_step(cfg_t, tp, cache_t,
                                         torch.tensor(tok), 32 + t)
        assert out is cache_t
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        _hold_cache(cache_j, cache_t, f"decode {t}")


@pytest.mark.parametrize("variant", ["plain", "shared-dense"])
def test_prefill_decode_consistency(variant):
    """The twin of tests/test_arch_smoke.py's test_prefill_decode_
    consistency for phi3.5 on the port alone: prefill of S - 1 tokens, a
    decode of the last, against the forward's logits at S - 1 within the
    reference's 0.05 of their scale."""
    _, cfg = configs(VARIANTS[variant])
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    S = 12
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, S)))
    full, _ = tmodel.forward_train(cfg, params, toks)
    _, cache = tmodel.prefill(cfg, params, toks[:, :S - 1], cache_len=S + 2)
    logits, _ = tmodel.decode_step(cfg, params, cache, toks[:, S - 1:],
                                   S - 1)
    ref = full[:, S - 1]
    err = float((logits - ref).abs().max())
    assert err / (float(ref.abs().max()) + 1e-6) < CONSISTENCY_GATE


def test_serving_steps_take_the_moe_config():
    """``init_cache`` of the full config equals the reference's
    ``jax.eval_shape`` (bf16 K/V over all 32 layers); the serving steps run
    the reduced one."""
    cfg_j, cfg_t = jbase.get_config(NAME), tbase.get_config(NAME)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 2, 64))
    out = tmodel.init_cache(cfg_t, 2, 64, device="cpu")
    assert sorted(ref) == sorted(out)
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(out[k].shape), k
        assert out[k].dtype == torch.bfloat16
    _, cfg = configs(VARIANTS["shared-dense"])
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    logits, cache = tsteps.make_prefill_step(cfg)(params, toks)
    again, _ = tsteps.make_serve_step(cfg)(params, cache, toks[:, :1], 7)
    assert torch.isfinite(logits).all() and torch.isfinite(again).all()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["plain", "shared-dense"])
def test_train_step_matches_reference(variant, monkeypatch):
    """3 AdamW steps from the same params and state, at
    ``test_torch_lm_train``'s tolerance for phi4-mini under AdamW (the
    losses, every element of every leaf, each leaf against the reference's
    movement); the loss carries the routers' aux, and the routers move."""
    jcfg, tcfg = configs(VARIANTS[variant])
    data = lmt.batches(tcfg)
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grads = lmt.reference_grads(jcfg, jp0, data[0], monkeypatch)
    jp, tp, losses = lmt.train_both(jcfg, tcfg, data)
    tol = lmt.TOL[("phi4-mini-3.8b", "adamw")]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    leaves = tsteps.param_leaves(tp)
    faults, noise = lmt.param_faults(tol, jp0, jp, leaves, grads)
    assert faults == [] and noise <= lmt.NOISE_SHARE, (faults, noise)
    tp0 = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp0),
                                        "cpu")
    assert not torch.equal(tp["blocks"]["moe"]["w_router"],
                           tp0["blocks"]["moe"]["w_router"])
    total, parts = tmodel.lm_loss(tcfg, tp0, {
        k: torch.as_tensor(v) for k, v in data[0].items()})
    assert float(parts["aux"]) > 0.0
    assert losses[0][1] == pytest.approx(float(total), rel=1e-6)


def test_launch_train_script_runs_phi35():
    """``python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b
    --reduced --steps 20`` on the CPU: the loss falls."""
    out = lmt.run_module("repro_torch.launch.train", "--arch", NAME,
                         "--reduced", "--steps", "20", "--device", "cpu")
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")][0]
    assert float(final.split()[2]) < float(final.split()[4][:-1])
