"""Parity of the port's serving path with the reference: ``init_cache``,
``prefill`` and ``decode_step`` over GQA and RWKV-6 caches, float8 KV
caches, ``launch.steps`` and ``convert.cache_from_jax``, at ``reduced()``
sizes.

The same numpy-seeded tokens go through both packages; the reference's
parameters come over through ``convert.model_params_from_jax`` and its
caches through ``convert.cache_from_jax``, so a decode is held from the
reference's own prefilled cache.  Everything is float32 unless a test says
otherwise, as in ``test_torch_lm.py``, whose logit tolerance holds here.
The reference's serving path launches no Pallas kernel (its prefill runs
the reference mixers), so nothing here runs in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import frontend as tfe
from repro_torch.models import model as tmodel
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_lm import LOGIT_ATOL

NAMES = ("phi4-mini-3.8b", "rwkv6-3b", "qwen1.5-32b", "mistral-large-123b",
         "llama3-405b", "deepseek-v3-671b", "seamless-m4t-large-v2",
         "qwen2-vl-2b")
DENSE = ("phi4-mini-3.8b", "qwen1.5-32b", "mistral-large-123b",
         "llama3-405b")
F8 = "float8_e4m3fn"

# K and V are O(1) projections of O(1) normed inputs: float32 parity to a
# few ulp, held at the logits' 2e-5.  The WKV state sums k^T v over the
# sequence (|S| up to ~20 here): 1e-5 of its largest value, as
# test_torch_lm holds the recurrence
CACHE_ATOL, STATE_RTOL = LOGIT_ATOL, 1e-5

# a float8 cache against a bfloat16 one, block by block on the same input:
# e4m3 keeps 3 mantissa bits (each K/V off by up to 2^-4 of itself), the
# bfloat16 cache 8; a block's update then moves by up to ~5% of its RMS at
# reduced width (0.051 read, float32 and bfloat16 compute): 0.1 allowed
TOL_FLOAT8_BLOCK = 0.1

# the reference's test_prefill_decode_consistency gate
CONSISTENCY_GATE = 0.05


def _cfgs(name, **changes):
    return (dataclasses.replace(jbase.get_config(name).reduced(), **changes),
            dataclasses.replace(tbase.get_config(name).reduced(), **changes))


def _params(cfg_j, cfg_t, seed=0):
    """The reference's random parameters in both packages.  A qkv_bias
    config's biases start at zero, so they are drawn here (N(0, 0.1)) to
    make the bias path count."""
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(seed))
    if cfg_j.qkv_bias:
        rng = np.random.default_rng(seed + 100)
        attn = dict(jp["blocks"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(0.1 * rng.standard_normal(
                attn[b].shape), attn[b].dtype)
        jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    tree = jax.tree.map(np.asarray, jp)
    return jp, convert.model_params_from_jax(cfg_t, tree, device="cpu")


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _port_cache(cfg_t, cache_j):
    return convert.cache_from_jax(cfg_t, jax.tree.map(np.asarray, cache_j),
                                  device="cpu")


def _hold_cache(ref, out, what):
    """Every leaf of a cache: its shape and dtype, the KV and token-shift
    leaves within CACHE_ATOL, the WKV state within STATE_RTOL of its
    scale."""
    assert sorted(ref) == sorted(out), what
    for k in ref:
        r, o = np.asarray(ref[k], np.float32), out[k].float()
        assert tuple(r.shape) == tuple(out[k].shape), (what, k)
        assert np.dtype(ref[k].dtype).name == str(out[k].dtype).split(".")[1]
        if k == "state":
            assert max_diff(r, o)[0] <= STATE_RTOL * float(np.abs(r).max()), \
                (what, k)
        else:
            assert_close(r, o, CACHE_ATOL, f"{what} {k}")


# ---------------------------------------------------------------------------
# init_cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_init_cache_matches_reference_shapes(name):
    """The full configs' caches, as ``jax.eval_shape`` gives the
    reference's (the twin of tests/test_launch.py's fp8 check): the three
    big dense configs in float8_e4m3fn, phi4-mini in bfloat16, RWKV's
    state in float32 beside bfloat16 shift states, deepseek-v3's
    compressed MLA latent and rope key in bfloat16, seamless-m4t's cross
    K / V of 8 frames beside its K / V and qwen2-vl's K / V in bfloat16;
    all zero."""
    cfg_j, cfg_t = jbase.get_config(name), tbase.get_config(name)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 2, 64))
    out = tmodel.init_cache(cfg_t, 2, 64, device="cpu")
    assert sorted(ref) == sorted(out)
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(out[k].shape), k
        assert out[k].dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
        assert not out[k].view(torch.uint8).any(), k
    kv_dtype = out[{"rwkv6-3b": "xprev_t",
                    "deepseek-v3-671b": "c_kv"}.get(name, "k")].dtype
    assert kv_dtype == (torch.bfloat16 if name in (
        "phi4-mini-3.8b", "rwkv6-3b", "deepseek-v3-671b",
        "seamless-m4t-large-v2", "qwen2-vl-2b") else torch.float8_e4m3fn)
    over = tmodel.init_cache(cfg_t, 1, 8, dtype=torch.bfloat16, device="cpu")
    assert all(v.dtype == (torch.float32 if k == "state" else torch.bfloat16)
               for k, v in over.items())


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

SERVE_CASES = {
    "phi4-mini": ("phi4-mini-3.8b", {}, 64),
    # reduced() gives phi4-mini H = Hkv = 4; Hkv = 2 groups the queries
    "phi4-mini-gqa": ("phi4-mini-3.8b", {"num_kv_heads": 2}, 64),
    "rwkv6": ("rwkv6-3b", {}, 64),
    "rwkv6-s128": ("rwkv6-3b", {}, 128),    # the chunked reference path
    "qwen1.5": ("qwen1.5-32b", {}, 64),     # qkv_bias
    "mistral-large": ("mistral-large-123b", {}, 64),
    "llama3": ("llama3-405b", {}, 64),
}

# decode runs 4 steps from a cache of S + 3 positions: the fourth writes at
# pos = cache_len, past the end, which the reference clamps to the last slot
DECODE_STEPS, CACHE_EXTRA = 4, 3


@pytest.fixture(scope="module", params=sorted(SERVE_CASES))
def served(request):
    name, changes, S = SERVE_CASES[request.param]
    cfg_j, cfg_t = _cfgs(name, **changes)
    jp, tp = _params(cfg_j, cfg_t)
    toks = _tokens(cfg_j, (2, S), S)
    logits_j, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks),
                                       cache_len=S + CACHE_EXTRA)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jp=jp, tp=tp, toks=toks,
                logits_j=logits_j, cache_j=cache_j)


def test_prefill_matches_reference(served):
    """The next-token logits (B, V) and every cache leaf, filled for the
    S prompt positions and zero after them."""
    cfg_t, toks = served["cfg_t"], served["toks"]
    S = toks.shape[1]
    logits, cache = tmodel.prefill(cfg_t, served["tp"], torch.tensor(toks),
                                   cache_len=S + CACHE_EXTRA)
    assert logits.dtype == torch.float32
    assert logits.shape == (2, cfg_t.vocab_padded)
    assert_close(served["logits_j"], logits, LOGIT_ATOL, "prefill logits")
    _hold_cache(served["cache_j"], cache, "prefill")
    if "k" in cache:
        assert not cache["k"][:, :, S:].any() and cache["k"][:, :, :S].any()


def test_decode_matches_reference(served):
    """Four decode steps from the reference's prefilled cache, brought over
    by ``cache_from_jax``: the logits and every cache leaf after each
    step.  ``pos`` goes in as a Python int and as a 0-d tensor; the fourth
    step's pos = cache_len overwrites the last slot in both packages."""
    cfg_j, cfg_t = served["cfg_j"], served["cfg_t"]
    S = served["toks"].shape[1]
    cache_j = served["cache_j"]
    cache_t = _port_cache(cfg_t, cache_j)
    toks = _tokens(cfg_j, (2, DECODE_STEPS), 7)
    for t in range(DECODE_STEPS):
        pos = S + t
        tok = toks[:, t:t + 1]
        logits_j, cache_j = jmodel.decode_step(
            cfg_j, served["jp"], cache_j, jnp.asarray(tok), jnp.int32(pos))
        before = {k: v.clone() for k, v in cache_t.items()}
        logits, out = tmodel.decode_step(
            cfg_t, served["tp"], cache_t, torch.tensor(tok),
            torch.tensor(pos) if t % 2 else pos)
        assert out is cache_t                     # updated in place
        assert logits.shape == (2, cfg_t.vocab_padded)
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        _hold_cache(cache_j, cache_t, f"decode {t}")
        if "k" in cache_t:
            slot = min(pos, S + CACHE_EXTRA - 1)
            changed = (cache_t["k"] != before["k"]).any(dim=(0, 1, 3, 4))
            assert changed.nonzero().flatten().tolist() == [slot], pos


@pytest.mark.parametrize("cache_len", [40, 80])
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_prefill_cache_len_above_and_below_s(name, cache_len):
    """``cache_len`` below S cuts the KV cache to its first positions,
    above S pads it with zeros; RWKV's cache ignores it."""
    cfg_j, cfg_t = _cfgs(name)
    jp, tp = _params(cfg_j, cfg_t, seed=1)
    toks = _tokens(cfg_j, (2, 64), 3)
    logits_j, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks),
                                       cache_len=cache_len)
    logits, cache = tmodel.prefill(cfg_t, tp, torch.tensor(toks),
                                   cache_len=cache_len)
    assert_close(logits_j, logits, LOGIT_ATOL, "logits")
    _hold_cache(cache_j, cache, f"cache_len {cache_len}")
    if name == "rwkv6-3b":
        _, whole = tmodel.prefill(cfg_t, tp, torch.tensor(toks))
        assert all(torch.equal(cache[k], whole[k]) for k in cache)
    else:
        assert cache["k"].shape[2] == cache_len


@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_consistency(name):
    """The twin of tests/test_arch_smoke.py's test_prefill_decode_
    consistency on the port alone, its own random parameters: prefill of
    S - 1 tokens into a cache of S + 2, then a decode of the last token
    matches the teacher-forced forward's logits at S - 1 within the
    reference's 0.05 of their scale.  A frontend config's forward and
    prefill take the embeddings of a 16-token prompt, as the reference's
    test draws them."""
    cfg = tbase.get_config(name).reduced()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    S = 12
    toks = torch.tensor(_tokens(cfg, (2, S), 0))
    fe = None
    if cfg.frontend:
        fe = torch.tensor(np.random.default_rng(1).standard_normal(
            (2, tfe.num_frontend_tokens(cfg, 16), tfe.frontend_dim(cfg))),
            dtype=torch.float32)
    full, _ = tmodel.forward_train(cfg, params, toks, fe)
    _, cache = tmodel.prefill(cfg, params, toks[:, :S - 1], cache_len=S + 2,
                              frontend_embeds=fe)
    logits, _ = tmodel.decode_step(cfg, params, cache, toks[:, S - 1:],
                                   S - 1)
    ref = full[:, S - 1]
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max()) + 1e-6
    assert err / scale < CONSISTENCY_GATE, (name, err, scale)


# ---------------------------------------------------------------------------
# float8 caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", DENSE)
def test_float8_decode_matches_reference_bits(name):
    """A float8_e4m3fn KV cache (``kv_cache_dtype`` set after
    ``reduced()``, which clears it): 4 decode steps from ``init_cache`` in
    both packages; the cache's uint8 bits equal the reference's after each
    step, the logits within LOGIT_ATOL.  Then, block by block on the same
    inputs, the port's float8 decode against its decode from a bfloat16
    cache (``init_cache(dtype=torch.bfloat16)``): each block's update
    within TOL_FLOAT8_BLOCK of its RMS (the chip run's tolerance too)."""
    cfg_j, cfg_t = _cfgs(name, kv_cache_dtype=F8)
    jp, tp = _params(cfg_j, cfg_t, seed=2)
    cache_j = jmodel.init_cache(cfg_j, 2, 8)
    cache_t = tmodel.init_cache(cfg_t, 2, 8, device="cpu")
    assert cache_j["k"].dtype == jnp.float8_e4m3fn
    assert cache_t["k"].dtype == torch.float8_e4m3fn
    toks = _tokens(cfg_j, (2, DECODE_STEPS), 11)
    for t in range(DECODE_STEPS):
        tok = toks[:, t:t + 1]
        logits_j, cache_j = jmodel.decode_step(cfg_j, jp, cache_j,
                                               jnp.asarray(tok), jnp.int32(t))
        logits, _ = tmodel.decode_step(cfg_t, tp, cache_t, torch.tensor(tok),
                                       t)
        for k in ("k", "v"):
            bits = np.asarray(cache_j[k]).view(np.uint8)
            assert np.array_equal(bits, cache_t[k].view(torch.uint8).numpy()
                                  ), (t, k)
        assert_close(logits_j, logits, LOGIT_ATOL, f"step {t} logits")
    # the port's float8 cache against a bfloat16 one, block by block
    c8 = tmodel.init_cache(cfg_t, 2, 8, device="cpu")
    cb = tmodel.init_cache(cfg_t, 2, 8, dtype=torch.bfloat16, device="cpu")
    worst = 0.0
    for t in range(DECODE_STEPS):
        h = tmodel._embed(cfg_t, tp, torch.tensor(toks[:, t:t + 1]))
        pos = tmodel._pos_tensor(t, "cpu")
        for i in range(cfg_t.num_layers):
            bp = tmodel.layer(tp["blocks"], i)
            o8, _ = tmodel._decode_block(cfg_t, h, bp,
                                         {k: v[i] for k, v in c8.items()},
                                         pos)
            ob, _ = tmodel._decode_block(cfg_t, h, bp,
                                         {k: v[i] for k, v in cb.items()},
                                         pos)
            d, b = (o8 - h).float(), (ob - h).float()
            worst = max(worst, float(d.sub(b).square().mean().sqrt()
                                     / b.square().mean().sqrt()))
            h = ob
    assert 0.0 < worst <= TOL_FLOAT8_BLOCK, worst


def test_float8_cache_write_past_448_matches_reference():
    """Values at and past e4m3's largest finite 448 (and infinities, NaNs)
    written into a float8 cache: torch's own cast saturates to +-448, the
    reference's (XLA, ml_dtypes) rounds past 464 to NaN; the port's
    ``cache_write`` gives the reference's bits.  One V entry of 1000 in a
    decode step likewise."""
    vals = np.array([0.1, -2.5, 447.0, 448.0, 460.0, 464.0, 470.0, 480.0,
                     500.0, 1000.0, -600.0, 1e6, np.inf, -np.inf, np.nan,
                     -np.nan], np.float32)
    assert not np.array_equal(
        torch.tensor(vals).to(torch.float8_e4m3fn).view(torch.uint8).numpy(),
        vals.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
    new = vals.reshape(1, 1, 2, 8)
    for pos in (1, 3, 9):                        # 9 clamps to the last slot
        ref = jattn.cache_write(jnp.zeros((1, 4, 2, 8), jnp.float8_e4m3fn),
                                jnp.asarray(new), jnp.int32(pos))
        out = tattn.cache_write(torch.zeros((1, 4, 2, 8),
                                            dtype=torch.float8_e4m3fn),
                                torch.tensor(new), torch.tensor(pos))
        assert np.array_equal(np.asarray(ref).view(np.uint8),
                              out.view(torch.uint8).numpy()), pos
    # through decode_attention: one V projection of ~1000
    cfg_j, cfg_t = _cfgs("llama3-405b", kv_cache_dtype=F8)
    p = jattn.init_attention(cfg_j, jax.random.PRNGKey(4))
    x = np.random.default_rng(5).standard_normal(
        (2, 1, cfg_j.d_model)).astype(np.float32)
    wv = np.array(p["wv"])
    wv[:, 3] = 1000.0 * np.sign(x[0, 0]) / np.abs(x[0, 0]).sum()
    p = {**p, "wv": jnp.asarray(wv)}
    dh = cfg_j.resolved_head_dim
    kv = jnp.zeros((2, 6, cfg_j.num_kv_heads, dh), jnp.float8_e4m3fn)
    ref = jattn.decode_attention(cfg_j, p, jnp.asarray(x), kv, kv,
                                 jnp.int32(2))
    kv_t = torch.zeros((2, 6, cfg_t.num_kv_heads, dh),
                       dtype=torch.float8_e4m3fn)
    out = tattn.decode_attention(cfg_t, {k: torch.tensor(np.asarray(v))
                                         for k, v in p.items()},
                                 torch.tensor(x), kv_t, kv_t.clone(),
                                 torch.tensor(2))
    v_bits = np.asarray(ref[2]).view(np.uint8)
    assert v_bits[0, 2, 0, 3] == 0x7F                 # 1000 -> NaN
    assert np.array_equal(v_bits, out[2].view(torch.uint8).numpy())
    np.testing.assert_allclose(np.asarray(ref[0]), out[0].numpy(),
                               atol=LOGIT_ATOL, equal_nan=True)
    assert np.isnan(out[0][0].numpy()).any()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_prefill_cache_is_the_compute_dtype(compute):
    """A reference quirk the port keeps: ``prefill`` fills its cache in the
    compute dtype, not ``kv_cache_dtype``, so a float8 config decodes from
    a float8 cache only after ``init_cache``.  Both packages alike, and a
    decode from the prefilled cache keeps its dtype."""
    cfg_j, cfg_t = _cfgs("llama3-405b", kv_cache_dtype=F8,
                         compute_dtype=compute)
    jp, tp = _params(cfg_j, cfg_t, seed=3)
    toks = _tokens(cfg_j, (2, 16), 4)
    _, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks))
    _, cache_t = tmodel.prefill(cfg_t, tp, torch.tensor(toks))
    want = getattr(torch, compute)
    assert np.dtype(cache_j["k"].dtype).name == compute
    assert cache_t["k"].dtype == cache_t["v"].dtype == want
    assert tmodel.init_cache(cfg_t, 2, 16, device="cpu")["k"].dtype == \
        torch.float8_e4m3fn
    tmodel.decode_step(cfg_t, tp, cache_t, torch.tensor(toks[:, :1]), 15)
    assert cache_t["k"].dtype == want


# ---------------------------------------------------------------------------
# the serving steps, convert, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_serving_steps_equal_the_direct_calls(name):
    """``make_prefill_step`` (any valid backend: prefill runs the reference
    mixers) and ``make_serve_step`` compute exactly what ``prefill`` and
    ``decode_step`` do; an unknown backend raises in both packages."""
    cfg_j, cfg_t = _cfgs(name)
    _, tp = _params(cfg_j, cfg_t, seed=5)
    toks = torch.tensor(_tokens(cfg_t, (2, 16), 6))
    logits, cache = tmodel.prefill(cfg_t, tp, toks)
    for backend in (None, "reference", "pallas"):
        lg, c = tsteps.make_prefill_step(cfg_t, backend=backend)(tp, toks)
        assert torch.equal(lg, logits)
        assert all(torch.equal(c[k], cache[k]) for k in cache)
    tok = toks[:, :1]
    direct = {k: v.clone() for k, v in cache.items()}
    want, _ = tmodel.decode_step(cfg_t, tp, direct, tok, 16)
    got, stepped = tsteps.make_serve_step(cfg_t)(tp, cache, tok, 16)
    assert torch.equal(got, want) and stepped is cache
    assert all(torch.equal(cache[k], direct[k]) for k in cache)
    with pytest.raises(ValueError, match="unknown model backend 'tpu'"):
        tsteps.make_prefill_step(cfg_t, backend="tpu")
    with pytest.raises(ValueError, match="unknown kernel backend 'tpu'"):
        jsteps.make_prefill_step(cfg_j, backend="tpu")


def test_cache_from_jax_keeps_every_bit():
    """bfloat16 leaves through float32 (exact), float8_e4m3fn through
    their uint8 bits, float32 states as they are; a cache of another
    depth is refused."""
    cfg_j, cfg_t = _cfgs("llama3-405b", kv_cache_dtype=F8,
                         compute_dtype="bfloat16")
    jp, tp = _params(cfg_j, cfg_t, seed=6)
    toks = _tokens(cfg_j, (2, 8), 8)
    _, bf = jmodel.prefill(cfg_j, jp, jnp.asarray(toks))
    f8 = {k: v.astype(jnp.float8_e4m3fn) for k, v in bf.items()}
    cfg_r = tbase.get_config("rwkv6-3b").reduced()
    rw = {"state": np.random.default_rng(9).standard_normal(
        (2, 2, cfg_r.num_heads, 32, 32)).astype(np.float32)}
    for tree, cfg in ((bf, cfg_t), (f8, cfg_t), (rw, cfg_r)):
        tree = jax.tree.map(np.asarray, tree)
        out = convert.cache_from_jax(cfg, tree, device="cpu")
        for k, a in tree.items():
            assert str(out[k].dtype) == f"torch.{a.dtype.name}", k
            nbytes = a.dtype.itemsize
            view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[nbytes]
            assert np.array_equal(
                a.view({1: np.uint8, 2: np.int16, 4: np.int32}[nbytes]),
                out[k].view(view).numpy()), k
    with pytest.raises(ValueError, match="stacked layers"):
        convert.cache_from_jax(tbase.get_config("llama3-405b"),
                               jax.tree.map(np.asarray, bf), device="cpu")


UNPORTED = {
    "moe": {"moe": tbase.MoEConfig(num_experts=4, top_k=2, d_ff_expert=64)},
    "mla": {"attention_kind": "mla", "mla": tbase.MLAConfig()},
    "hybrid": {"attention_kind": "hybrid",
               "ssm": tbase.SSMConfig(kind="mamba", state_size=8)},
    "hybrid-rwkv6": {"attention_kind": "hybrid", "ssm": tbase.SSMConfig()},
    "encoder-decoder": {"encoder_layers": 2, "frontend": "audio"},
    "frontend": {"frontend": "audio"},
    "mtp": {"mtp": True},
    "mrope": {"rope_kind": "mrope"},
}


# parts ported since their refusal case was written: each case now checks
# that the serving entry points accept such a config
PORTED = ("moe", "hybrid", "mla", "mtp", "encoder-decoder", "frontend",
          "mrope")


@pytest.mark.parametrize("part", sorted(UNPORTED))
def test_serving_refuses_unported_configs(part):
    """Every serving entry point refuses what the model path does not
    port, as ``init_params`` and ``forward_train`` do.  A part ported since
    (``PORTED``) keeps its case: the four entry points accept such a
    config, and ``init_cache`` equals the reference's ``jax.eval_shape``."""
    cfg = dataclasses.replace(tbase.get_config("phi4-mini-3.8b").reduced(),
                              **UNPORTED[part])
    if part in PORTED:
        serving_accepts(part, cfg)
        return
    good = tbase.get_config("phi4-mini-3.8b").reduced()
    params = tmodel.init_params(good, seed=0, device="cpu")
    cache = tmodel.init_cache(good, 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for call in (lambda: tmodel.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: tmodel.prefill(cfg, params, tok),
                 lambda: tmodel.decode_step(cfg, params, cache, tok, 0),
                 lambda: tsteps.make_serve_step(cfg)(params, cache, tok, 0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            call()


def serving_accepts(part, cfg):
    """init_cache (against the reference's shapes and dtypes), prefill,
    decode_step and the serve step on ``cfg`` with its own parameters:
    finite logits of the padded vocabulary.  A frontend config's prefill
    takes the embeddings of its one-token prompt (8 frames or patches)."""
    changes = {"moe": {"moe": jbase.MoEConfig(num_experts=4, top_k=2,
                                              d_ff_expert=64)},
               "hybrid": {"attention_kind": "hybrid",
                          "ssm": jbase.SSMConfig(kind="mamba",
                                                 state_size=8)},
               "mla": {"attention_kind": "mla", "mla": jbase.MLAConfig()},
               "mtp": {"mtp": True},
               "encoder-decoder": {"encoder_layers": 2, "frontend": "audio"},
               "frontend": {"frontend": "audio"},
               "mrope": {"rope_kind": "mrope"}}[part]
    cfg_j = dataclasses.replace(jbase.get_config("phi4-mini-3.8b").reduced(),
                                **changes)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 1, 4))
    cache = tmodel.init_cache(cfg, 1, 4, device="cpu")
    assert sorted(ref) == sorted(cache)
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(cache[k].shape), k
        assert cache[k].dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    fe = None
    if cfg.frontend:
        fe = torch.ones((1, tfe.num_frontend_tokens(cfg, 1),
                         tfe.frontend_dim(cfg)))
    outs = [tmodel.prefill(cfg, params, tok, cache_len=4,
                           frontend_embeds=fe)[0],
            tmodel.decode_step(cfg, params, cache, tok, 1)[0],
            tsteps.make_serve_step(cfg)(params, cache, tok, 2)[0]]
    for logits in outs:
        assert logits.shape == (1, cfg.vocab_padded)
        assert bool(torch.isfinite(logits).all())


def test_decode_takes_an_int_or_a_tensor_position():
    """``pos`` as a Python int and as a 0-d int32 tensor decode alike: the
    same logits, the token written at that slot only."""
    cfg = tbase.get_config("phi4-mini-3.8b").reduced()
    params = tmodel.init_params(cfg, seed=1, device="cpu")
    a = tmodel.init_cache(cfg, 1, 6, device="cpu")
    b = {k: v.clone() for k, v in a.items()}
    tok = torch.tensor([[5]])
    la, _ = tmodel.decode_step(cfg, params, a, tok, 3)
    lb, _ = tmodel.decode_step(cfg, params, b, tok,
                               torch.tensor(3, dtype=torch.int32))
    assert torch.equal(la, lb)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert to_np(a["k"][:, :, 3]).any() and not to_np(a["k"][:, :, 4]).any()
