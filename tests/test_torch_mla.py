"""Parity of the port's Multi-head Latent Attention, the MTP head and
``deepseek-v3-671b`` with the reference: ``models/mla.py`` (``_rms``,
``_project``, the expanded ``apply_mla``, the absorbed ``decode_mla``),
the model's MLA and MTP branches through ``forward_train``, ``lm_loss``,
``prefill``, ``decode_step`` and ``make_train_step``, ``convert``, the
roofline's counts and the training script, at ``reduced()`` sizes (2
layers, 1 dense and 1 MoE, d 256, 4 heads, q_lora 64, kv_lora 32, nope
64, rope 16; float32 unless a test says otherwise); and the top-8
combine of the mixture of experts.

The same numpy-seeded inputs go through both packages; the reference runs
plain JAX on the CPU (MLA takes no kernel backend in either package, so
nothing runs in interpret mode) and its parameters come over through
``convert.model_params_from_jax``, its caches through
``convert.cache_from_jax``.  Every model-level input asserts the two
packages route alike at the MoE layer, with each token's k-th / (k+1)-th
probability gap above ``test_torch_moe``'s MIN_GAP_MODEL and 10x the
packages' probability difference.  Tolerances:

* MLA's O(1) outputs in float32 within :data:`MLA_ATOL` (float32 products
  and softmax of another summation order; read below 2e-6);
* the logits and loss within ``test_torch_lm``'s LOGIT_ATOL / LOSS_ATOL,
  the aux (the router's loss and the MTP term) within LOSS_ATOL, the
  caches within ``test_torch_serve``'s;
* the train step's gradients within :data:`GRAD_TOL` of each leaf's RMS,
  plus one bfloat16 ulp of each microbatch's gradient where Adafactor
  accumulates in bfloat16, as ``test_torch_lm_train`` holds phi4-mini; its
  params at ``test_torch_lm_train``'s Adafactor tolerance for phi4-mini;
* bfloat16 results by rel-RMS and the worst difference over the largest
  |value|, each tolerance stated at its test; the MoE combine at top 8 bit
  for bit (its test derives the bound an unordered sum would need).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import roofline as troof
from repro_torch.launch import steps as tsteps
from repro_torch.models import mla as tmla
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from tests import test_torch_lm_train as lmt
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_lm import LOGIT_ATOL, LOSS_ATOL
from tests.test_torch_moe import (BF16_DISPATCH_TOL, MIN_GAP,
                                  MIN_GAP_MODEL, ROUTER_TOL, min_gap,
                                  reference_keep, router_probs,
                                  routing_agrees)
from tests.test_torch_serve import (CONSISTENCY_GATE, _hold_cache,
                                    _port_cache)

NAME = "deepseek-v3-671b"
MLA_ATOL = 1e-5
GRAD_TOL = 1e-4
# the share of elements whose first-step gradient sits at the noise floor
# in the 3-step parity (``test_torch_lm_train``'s rule): 3.4% read here,
# where phi4-mini reads up to 1.6% (its 2.5%): the 4 experts' rows that a
# few tokens reach carry small gradients
NOISE_SHARE = 0.05


def configs(**changes):
    """The reference's and the port's reduced deepseek-v3, replaced by
    ``changes``."""
    return tuple(dataclasses.replace(base.get_config(NAME).reduced(),
                                     **changes) for base in (jbase, tbase))


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


def mla_params(cfg_j, seed=0):
    p = jmla.init_mla(cfg_j, jax.random.PRNGKey(seed))
    return p, tree_to_torch(jax.tree.map(np.asarray, p))


def positions(B, S, start=0):
    return np.broadcast_to(start + np.arange(S, dtype=np.int32), (B, S))


# the reduced config's MLA (nope 64, rope 16, v 64: a value head of 64
# under a query head of 80) and one at the 671B config's head widths (nope
# 128, rope 64, v 128) with 2 heads
HEADS = {"reduced": {},
         "671b-heads": {"num_heads": 2, "num_kv_heads": 2,
                        "mla": tbase.MLAConfig(
                            q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=128, qk_rope_head_dim=64,
                            v_head_dim=128)}}


def head_configs(variant):
    changes = dict(HEADS[variant])
    if "mla" in changes:
        cfg_j, cfg_t = configs()
        m = dataclasses.asdict(changes.pop("mla"))
        return (dataclasses.replace(cfg_j, mla=jbase.MLAConfig(**m),
                                    **changes),
                dataclasses.replace(cfg_t, mla=tbase.MLAConfig(**m),
                                    **changes))
    return configs()


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """The port's deepseek-v3, full and reduced, field by field: MLA, 256
    experts top 8 with a shared expert and 3 dense layers (reduced: 4
    experts top 2, 1 dense layer, cf 8.0), ``impl="shard_map"``, MTP,
    Adafactor over 4 microbatches."""
    ref, out = jbase.get_config(NAME), tbase.get_config(NAME)
    assert dataclasses.asdict(ref) == dataclasses.asdict(out)
    assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(
        out.reduced())
    assert out.attention_kind == "mla" and out.mtp
    assert (out.optimizer, out.train_microbatches) == ("adafactor", 4)
    assert (out.moe.top_k, out.moe.impl) == (8, "shard_map")
    red = out.reduced()
    assert (red.num_layers, red.d_model, red.num_heads) == (2, 256, 4)
    assert dataclasses.astuple(red.mla) == (64, 32, 64, 16, 64)
    assert NAME in tbase.list_configs()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def test_rms_matches_reference():
    """MLA's own RMSNorm (float32, eps 1e-6), not ``apply_norm``: 1e-6 on
    unit-scale outputs; a bf16 input comes back bf16 within one ulp."""
    cfg_j, cfg_t = configs()
    x = rand((2, 5, 32), 1, 3.0)
    p = {"scale": rand((32,), 2)}
    ref = jmla._rms(cfg_j, {"scale": jnp.asarray(p["scale"])},
                    jnp.asarray(x))
    out = tmla._rms(cfg_t, tree_to_torch(p), torch.tensor(x))
    assert_close(ref, out, 1e-6, "rms")
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16)).astype(np.float32)
    ref = jmla._rms(cfg_j, {"scale": jnp.asarray(p["scale"])},
                    jnp.asarray(xb, jnp.bfloat16))
    out = tmla._rms(cfg_t, tree_to_torch(p),
                    torch.tensor(xb).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref, np.float32)
    assert max_diff(ref, out.float())[0] <= 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize("variant", sorted(HEADS))
def test_project_matches_reference(variant):
    """The four projections: q_nope, q_rope, the normed latent, the rope
    key before RoPE."""
    cfg_j, cfg_t = head_configs(variant)
    jp, tp = mla_params(cfg_j, 1)
    x = rand((2, 8, cfg_j.d_model), 2)
    ref = jmla._project(cfg_j, jp, jnp.asarray(x))
    out = tmla._project(cfg_t, tp, torch.tensor(x))
    m = cfg_t.mla
    H = cfg_t.num_heads
    shapes = [(2, 8, H, m.qk_nope_head_dim), (2, 8, H, m.qk_rope_head_dim),
              (2, 8, m.kv_lora_rank), (2, 8, m.qk_rope_head_dim)]
    for name, r, o, shape in zip(("q_nope", "q_rope", "c_kv", "k_rope"),
                                 ref, out, shapes):
        assert tuple(o.shape) == shape, name
        assert_close(r, o, MLA_ATOL, name)


@pytest.mark.parametrize("variant,S", [("reduced", 32), ("671b-heads", 32),
                                       ("reduced", 1100)])
def test_apply_mla_matches_reference(variant, S):
    """The expanded form at S 32, and at S 1100, past the 1024-query chunk
    of ``chunked_gqa_attend`` (two chunks); at the 671B head widths a
    value head of 128 comes out of a query head of 192.  With
    ``return_cache`` the same output beside the latent and the roped key
    the reference's prefill caches."""
    cfg_j, cfg_t = head_configs(variant)
    jp, tp = mla_params(cfg_j, 3)
    B = 2 if S < 1024 else 1
    x = rand((B, S, cfg_j.d_model), 4)
    pos = positions(B, S)
    ref = jmla.apply_mla(cfg_j, jp, jnp.asarray(x), jnp.asarray(pos))
    out, c_kv, k_rope = tmla.apply_mla(cfg_t, tp, torch.tensor(x),
                                       torch.tensor(pos), return_cache=True)
    assert tuple(out.shape) == (B, S, cfg_t.d_model)
    assert_close(ref, out, MLA_ATOL, f"apply_mla S {S}")
    assert torch.equal(out, tmla.apply_mla(cfg_t, tp, torch.tensor(x),
                                           torch.tensor(pos)))
    _, _, c_ref, r_ref = jmla._project(cfg_j, jp, jnp.asarray(x))
    r_ref = jlayers.apply_rope(r_ref[:, :, None, :], jnp.asarray(pos),
                               cfg_j.rope_theta)[:, :, 0, :]
    assert_close(c_ref, c_kv, MLA_ATOL, "c_kv")
    assert_close(r_ref, k_rope, MLA_ATOL, "k_rope")


def decode_inputs(cfg_j, S=16, pos=9, seed=5, dtype=np.float32):
    """A token, and latent and rope caches of S positions filled at
    positions below ``pos`` (zeros after, as a prefill leaves them)."""
    m = cfg_j.mla
    x = rand((2, 1, cfg_j.d_model), seed)
    c = rand((2, S, m.kv_lora_rank), seed + 1)
    r = rand((2, S, m.qk_rope_head_dim), seed + 2)
    c[:, pos:] = 0.0
    r[:, pos:] = 0.0
    return [a.astype(dtype) for a in (x, c, r)]


@pytest.mark.parametrize("variant,pos", [("reduced", 9), ("reduced", 15),
                                         ("reduced", 16),
                                         ("671b-heads", 9)])
def test_decode_mla_matches_reference(variant, pos):
    """The absorbed form against a compressed cache of 16 positions: the
    output, and both caches written in place at ``pos`` (pos 16 is past the
    end: clamped to the last slot in both), the other slots untouched."""
    cfg_j, cfg_t = head_configs(variant)
    jp, tp = mla_params(cfg_j, 6)
    x, c, r = decode_inputs(cfg_j, pos=min(pos, 15))
    ref, c_ref, r_ref = jmla.decode_mla(cfg_j, jp, jnp.asarray(x),
                                        jnp.asarray(c), jnp.asarray(r),
                                        jnp.int32(pos))
    ct, rt = torch.tensor(c), torch.tensor(r)
    out, c_out, r_out = tmla.decode_mla(cfg_t, tp, torch.tensor(x), ct, rt,
                                        torch.tensor(pos))
    assert c_out is ct and r_out is rt
    assert tuple(out.shape) == (2, 1, cfg_t.d_model)
    assert_close(ref, out, MLA_ATOL, "decode_mla")
    assert_close(c_ref, ct, MLA_ATOL, "c_kv")
    assert_close(r_ref, rt, MLA_ATOL, "k_rope")
    slot = min(pos, 15)
    keep = [i for i in range(16) if i != slot]
    assert np.array_equal(to_np(ct)[:, keep], c[:, keep])
    assert np.array_equal(to_np(rt)[:, keep], r[:, keep])


def test_decode_mla_bfloat16_matches_reference_bits():
    """bf16 params, compute and caches: the two logit products summed in
    bf16 and only then cast to float32 and scaled, as the reference does.
    On this CPU the output and both caches then equal the reference's bit
    for bit (three seeds read); summing the two products in float32
    instead leaves 38% to 47% of the outputs equal, 3.4e-3 to 4.3e-3
    rel-RMS apart."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jmla.init_mla(cfg_j, jax.random.PRNGKey(7))
    tp = {k: v.to(torch.bfloat16) if torch.is_tensor(v)
          else {"scale": v["scale"].to(torch.bfloat16)}
          for k, v in tree_to_torch(jax.tree.map(np.asarray, jp)).items()}
    x, c, r = decode_inputs(cfg_j, pos=11, seed=8)
    xb, cb, rb = (jnp.asarray(a, jnp.bfloat16) for a in (x, c, r))
    ref, c_ref, r_ref = jmla.decode_mla(cfg_j, jp, xb, cb, rb,
                                        jnp.int32(11))
    xt, ct, rt = (torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
                  for a in (xb, cb, rb))
    out, _, _ = tmla.decode_mla(cfg_t, tp, xt, ct, rt, torch.tensor(11))
    assert out.dtype == torch.bfloat16
    for a, b in ((ref, out), (c_ref, ct), (r_ref, rt)):
        assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())


# ---------------------------------------------------------------------------
# parameters, caches, the roofline's counts
# ---------------------------------------------------------------------------

def test_init_params_matches_reference_shapes():
    """The full config's tree on the meta device and the reduced one's
    (bf16 params): the same paths, shapes and dtypes as ``jax.eval_shape``
    of the reference's; the MLA leaves under ``mla``, the MTP head's one
    unstacked dense block and its norm under ``mtp``."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16")
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
        assert sorted(out["mtp"]) == ["block", "norm"]
        assert sorted(out["mtp"]["block"]) == ["ffn", "ln1", "ln2", "mla"]
        assert out["mtp"]["block"]["ln1"]["scale"].shape == (ct.d_model,)
        assert out["blocks"]["mla"]["wkv_b"].shape[0] == \
            ct.num_layers - ct.moe.first_dense_layers


def test_model_params_from_jax_takes_mla_and_mtp():
    """The reference's tree, MTP subtree and MLA leaves included, comes over
    leaf for leaf (bf16 bits exact, the router float32); the layer count
    reads the two stacks only, not the MTP block."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        cfg_j, jax.random.PRNGKey(0)))
    tp = convert.model_params_from_jax(cfg_t, tree, device="cpu")
    assert tp["mtp"]["block"]["mla"]["wq_a"].dtype == torch.bfloat16
    assert tp["blocks"]["moe"]["w_router"].dtype == torch.float32
    for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(tp)):
        assert np.array_equal(np.asarray(a, np.float32), t.float().numpy()), \
            path
    with pytest.raises(ValueError, match="2 stacked layers"):
        convert.model_params_from_jax(
            dataclasses.replace(cfg_t, num_layers=3), tree, device="cpu")


def test_param_leaves_follow_the_reference_order():
    """``launch.steps.leaves_with_paths`` (sorted keys, ``mtp`` last) walks
    the tree in ``jax.tree.leaves`` order, so an optimizer state lines up
    leaf for leaf; ``opt_state_from_jax`` brings Adafactor's state of the
    reduced config over in that order."""
    cfg_j, cfg_t = configs()
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    ref = ["/".join(str(k.key) for k in kp) for kp, _ in
           jax.tree_util.tree_flatten_with_path(jp)[0]]
    paths = [p for p, _ in tsteps.leaves_with_paths(
        tsteps.abstract_params(cfg_t))]
    assert paths == ref and paths[-1].startswith("mtp/")
    js = jax.tree.map(np.asarray, jsteps.make_opt(cfg_j).init(jp))
    ts = convert.opt_state_from_jax(cfg_t, js, "cpu")
    leaves = tsteps.param_leaves(tmodel.init_params(cfg_t, device="cpu"))
    assert len(ts) == len(leaves) == len(ref)
    for s, p, (path, _) in zip(ts, leaves, tsteps.leaves_with_paths(
            jax.tree.map(np.asarray, js))):
        assert set(s) == ({"vr", "vc"} if p.dim() >= 2 and
                          min(p.shape[-2:]) >= 128 else {"v"})


def test_param_counts_match_reference():
    """The full 671B config on the meta device: every count equal to the
    reference's ``abstract_params`` counts, ~671B total and ~37B active
    (the reference's tests/test_launch.py bounds), the experts counted at
    8 of 256; the model FLOPs of each input shape equal."""
    jcfg, tcfg = jbase.get_config(NAME), tbase.get_config(NAME)
    jshape, tshape = (jsteps.abstract_params(jcfg),
                      tsteps.abstract_params(tcfg))
    assert all(t.is_meta for t in tsteps.param_leaves(tshape))
    total = troof.param_count(tcfg, tshape)
    active = troof.active_param_count(tcfg, tshape)
    assert total == jroof.param_count(jcfg, jshape)
    assert active == jroof.active_param_count(jcfg, jshape)
    assert 6.3e11 < total < 7.2e11 and 3.0e10 < active < 5.0e10
    experts = 3 * 58 * 256 * 7168 * 2048
    assert active == total - experts + experts * 8 // 256
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert troof.model_flops(tcfg, tbase.INPUT_SHAPES[shape], tshape) \
            == jroof.model_flops(jcfg, jbase.INPUT_SHAPES[shape], jshape)


def test_init_cache_matches_reference_shapes():
    """The full config's compressed cache as ``jax.eval_shape`` gives the
    reference's: ``c_kv`` (61, B, S, 512) and ``k_rope`` (61, B, S, 64),
    bf16 and zero; 576 numbers a token and layer."""
    cfg_j, cfg_t = jbase.get_config(NAME), tbase.get_config(NAME)
    ref = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 2, 64))
    out = tmodel.init_cache(cfg_t, 2, 64, device="cpu")
    assert sorted(ref) == sorted(out) == ["c_kv", "k_rope"]
    for k, r in ref.items():
        assert tuple(r.shape) == tuple(out[k].shape), k
        assert out[k].dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
        assert not out[k].any(), k
    assert out["c_kv"].shape[-1] + out["k_rope"].shape[-1] == 576


# ---------------------------------------------------------------------------
# the model: forward, the MTP head, the loss, serving
# ---------------------------------------------------------------------------

# the token seed of the model parity input (the two packages route alike
# with a gap above MIN_GAP_MODEL at every MoE layer; asserted)
TOKEN_SEED = 40


@pytest.fixture(scope="module")
def model_case():
    cfg_j, cfg_t = configs()
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    rng = np.random.default_rng(TOKEN_SEED)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    gap, diff = routing_agrees(cfg_j, cfg_t, jp, tp, toks)
    assert gap > MIN_GAP_MODEL and gap > 10 * diff, (gap, diff)
    return cfg_j, cfg_t, jp, tp, toks, labels


def port_hidden(cfg_t, tp, toks):
    """The blocks' output before the final norm (the MTP head's input)."""
    h = tmodel._embed(cfg_t, tp, toks)
    pos = tmodel._positions(cfg_t, toks)
    for blocks in tmodel.block_stacks(tp):
        h, _ = tmodel._scan_blocks(cfg_t, blocks, h, positions=pos)
    return h


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(model_case, backend):
    """Logits within LOGIT_ATOL and the aux (the router's loss plus the MTP
    term) within LOSS_ATOL; MLA takes no backend in either package, so
    backend "pallas" gives what "reference" gives, bit for bit, and
    launches no kernel."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                        backend=backend)
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                    backend=backend)
    assert out.shape == (2, 32, cfg_t.vocab_padded)
    assert_close(ref, out, LOGIT_ATOL, f"{backend} logits")
    assert abs(float(aux) - float(aux_ref)) <= LOSS_ATOL
    if backend == "pallas":
        plain, plain_aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks))
        assert torch.equal(plain, out) and torch.equal(plain_aux, aux)


def test_mtp_term_matches_reference(model_case):
    """The MTP term on its own, from each package's own hidden states:
    0.3 times the mean cross entropy of token t + 2 over the first S - 2
    positions (within LOSS_ATOL; the rolled tokens wrap around, so the
    last two positions are left out), and the aux is the router's loss
    plus it."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    hj = jmodel._embed(cfg_j, jp, jnp.asarray(toks))
    pos = jmodel._positions(cfg_j, jnp.asarray(toks))
    hj, _ = jmodel._scan_blocks(cfg_j, jp["blocks_dense"], hj, positions=pos)
    hj, a_j = jmodel._scan_blocks(cfg_j, jp["blocks"], hj, positions=pos)
    ref = jmodel._mtp_loss_placeholder(cfg_j, jp, hj, jnp.asarray(toks))
    ht = port_hidden(cfg_t, tp, torch.tensor(toks))
    assert_close(hj, ht, LOGIT_ATOL, "h")
    out = tmodel._mtp_loss(cfg_t, tp, ht, torch.tensor(toks))
    assert abs(float(ref) - float(out)) <= LOSS_ATOL
    assert float(out) > 1.0                 # 0.3 x ~ln(512)
    _, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks))
    assert float(aux) == pytest.approx(float(out) + float(a_j), abs=1e-5)


@pytest.mark.parametrize("base", ["gqa", "mla"])
def test_mtp_head_takes_any_attention(base):
    """MTP on phi4-mini's reduced GQA and on the reduced MLA (the
    reference's head is generic): the tree, and the forward's logits and
    aux against the reference."""
    name = "phi4-mini-3.8b" if base == "gqa" else NAME
    changes = {"mtp": True, "moe": None}
    cfg_j = dataclasses.replace(jbase.get_config(name).reduced(), **changes)
    cfg_t = dataclasses.replace(tbase.get_config(name).reduced(), **changes)
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(3))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    assert ("attn" if base == "gqa" else "mla") in tp["mtp"]["block"]
    toks = np.random.default_rng(4).integers(
        0, cfg_j.vocab_size, (2, 16)).astype(np.int32)
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks))
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks))
    assert_close(ref, out, LOGIT_ATOL, f"{base} logits")
    assert float(aux) > 1.0
    assert abs(float(aux) - float(aux_ref)) <= LOSS_ATOL


def test_mtp_block_is_checkpointed_under_grad(monkeypatch):
    """With grad enabled the MTP block runs under ``torch.utils.checkpoint``
    whatever ``remat`` says (the reduced config's is ""), as the reference
    wraps it in ``jax.checkpoint``; under no_grad it does not."""
    _, cfg_t = configs()
    assert cfg_t.remat == ""
    seen = []
    real = tmodel.checkpoint
    monkeypatch.setattr(tmodel, "checkpoint",
                        lambda *a, **kw: seen.append(a[3]) or real(*a, **kw))
    tp = tmodel.init_params(cfg_t, seed=0, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.int64)
    with torch.no_grad():
        tmodel.forward_train(cfg_t, tp, tok)
    assert seen == []
    for p in tsteps.param_leaves(tp):
        p.requires_grad_(True)
    loss, _ = tmodel.lm_loss(cfg_t, tp, {"tokens": tok, "labels": tok})
    assert len(seen) == 1 and seen[0] is tp["mtp"]["block"]
    loss.backward()
    assert tp["mtp"]["block"]["mla"]["wq_a"].grad.abs().sum() > 0


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
            LOSS_ATOL
        assert float(out) == pytest.approx(float(parts["loss"])
                                           + float(parts["aux"]), abs=1e-6)


def test_prefill_and_decode_match_reference(model_case):
    """Prefill of S 32 into a cache of 35 positions (the logits, ``c_kv``
    and the roped ``k_rope``, zeros after S), then 4 absorbed-form decode
    steps from the reference's prefilled cache (``cache_from_jax``): the
    logits and both cache leaves after each step.  The fourth step writes
    past the end (clamped to the last slot in both)."""
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    logits_j, cache_j = jmodel.prefill(cfg_j, jp, jnp.asarray(toks),
                                       cache_len=35)
    logits, cache = tmodel.prefill(cfg_t, tp, torch.tensor(toks),
                                   cache_len=35)
    assert_close(logits_j, logits, LOGIT_ATOL, "prefill logits")
    _hold_cache(cache_j, cache, "prefill")
    assert sorted(cache) == ["c_kv", "k_rope"]
    assert cache["c_kv"].shape == (2, 2, 35, cfg_t.mla.kv_lora_rank)
    assert not cache["c_kv"][:, :, 32:].any() and cache["k_rope"][:, :,
                                                                  :32].any()
    cache_t = _port_cache(cfg_t, cache_j)
    steps = np.random.default_rng(41).integers(
        0, cfg_j.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        tok = steps[:, t:t + 1]
        logits_j, cache_j = jmodel.decode_step(
            cfg_j, jp, cache_j, jnp.asarray(tok), jnp.int32(32 + t))
        logits, out = tmodel.decode_step(cfg_t, tp, cache_t,
                                         torch.tensor(tok),
                                         torch.tensor(32 + t) if t % 2
                                         else 32 + t)
        assert out is cache_t
        assert_close(logits_j, logits, LOGIT_ATOL, f"decode {t} logits")
        _hold_cache(cache_j, cache_t, f"decode {t}")


@pytest.mark.parametrize("mtp", [True, False])
def test_prefill_decode_consistency(mtp):
    """The twin of tests/test_arch_smoke.py's test_prefill_decode_
    consistency for deepseek-v3 on the port alone, its own random
    parameters: prefill of S - 1 tokens, an absorbed-form decode of the
    last, against the expanded forward's logits at S - 1 within the
    reference's 0.05 of their scale.  Serving runs no MTP head: with and
    without one the serving logits are the same."""
    _, cfg = configs(mtp=mtp)
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
    if not mtp:
        with_mtp = tmodel.init_params(dataclasses.replace(cfg, mtp=True),
                                      seed=0, device="cpu")
        assert "mtp" in with_mtp and "mtp" not in params
        _, c2 = tmodel.prefill(cfg, with_mtp, toks[:, :S - 1],
                               cache_len=S + 2)
        assert all(torch.equal(cache[k][:, :, :S - 1], c2[k][:, :, :S - 1])
                   for k in cache)


def test_serving_steps_take_deepseek():
    """The serving steps on the reduced config: ``make_prefill_step`` and
    ``make_serve_step``, finite logits of the padded vocabulary."""
    _, cfg = configs()
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int64)
    logits, cache = tsteps.make_prefill_step(cfg)(params, toks)
    again, _ = tsteps.make_serve_step(cfg)(params, cache, toks[:, :1], 7)
    for x in (logits, again):
        assert x.shape == (1, cfg.vocab_padded) and torch.isfinite(x).all()


# a bf16 forward against the reference's at the reduced widths:
# (rel-RMS of the logits, worst |difference| over the largest |value|, the
# aux's relative difference).  bf16 roundings of matmuls of another
# summation order and of jax.nn.silu's rounded sigmoid (test_torch_moe)
# compound over 2 layers and the MTP block: read 9.5e-3, 1.1e-2 and
# 1.7e-5; 2x, ~3x and ~6x allowed
BF16_FORWARD_TOL = (2e-2, 2.0 ** -5, 1e-4)


def test_forward_bfloat16_matches_reference():
    """bf16 params and compute at the reduced widths: the logits and the
    aux (the router's loss in float32 plus the MTP term over bf16
    logits) against the reference's, within BF16_FORWARD_TOL."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    jp = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(cfg_t, jax.tree.map(np.asarray, jp),
                                       device="cpu")
    toks = np.random.default_rng(TOKEN_SEED).integers(
        0, cfg_j.vocab_size, (2, 32)).astype(np.int32)
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks))
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks))
    assert out.dtype == torch.float32
    ref, out = np.asarray(ref), out.numpy()
    rel = float(np.sqrt(np.mean((ref - out) ** 2) / np.mean(ref ** 2)))
    worst = max_diff(ref, out)[0] / float(np.abs(ref).max())
    d_aux = abs(float(aux) - float(aux_ref)) / abs(float(aux_ref))
    print(f"bf16 forward: rel-RMS {rel:.3e}, worst {worst:.3e}, aux "
          f"{d_aux:.3e}")
    assert rel <= BF16_FORWARD_TOL[0] and worst <= BF16_FORWARD_TOL[1] and \
        d_aux <= BF16_FORWARD_TOL[2], (rel, worst, d_aux)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def assert_routing_meaningful_on(cfg_j, cfg_t, jp, tp, toks):
    gap, diff = routing_agrees(cfg_j, cfg_t, jp, tp, toks)
    assert gap > MIN_GAP_MODEL and gap > 10 * diff, (gap, diff)


@pytest.mark.parametrize("n_mb", [1, 4])
def test_accumulated_gradients_match_reference(n_mb, monkeypatch):
    """The gradients the train step hands the config's Adafactor, read
    through a stub optimizer in both packages, over 1 and 4 microbatches
    (the config's count; B 4 x S 32): summed in bfloat16 and divided by
    the count, and the mean loss, against the reference's.  Each leaf
    within GRAD_TOL of its RMS plus, over 4 microbatches, one bfloat16 ulp
    (2^-7) of each microbatch's gradient, read from the reference's
    one-microbatch steps (``test_torch_lm_train``'s rule)."""
    lmt.stub_optimizers(monkeypatch)
    jcfg, tcfg = configs(train_microbatches=n_mb)
    assert tcfg.optimizer == "adafactor"
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                       "cpu")
    b = lmt.batches(tcfg, 1)[0]
    assert_routing_meaningful_on(jcfg, tcfg, jp, tp, b["tokens"])

    def reference(cfg, batch):
        g, _, _, m = jax.jit(jsteps.make_train_step(cfg))(
            jp, {}, jnp.int32(0), jax.tree.map(jnp.asarray, batch))
        return jax.tree.leaves(g), float(m["loss"])

    jg, jloss = reference(jcfg, b)
    parts = [] if n_mb == 1 else [
        reference(dataclasses.replace(jcfg, train_microbatches=1),
                  {k: v[i:i + 1] for k, v in b.items()})[0]
        for i in range(n_mb)]
    tg, loss = lmt.port_grads(tcfg, tp, b)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    for i, (path, a, t) in enumerate(zip(paths, jg,
                                         tsteps.param_leaves(tg))):
        a = np.asarray(a, np.float32).astype(np.float64)
        t = to_np(t.float()).astype(np.float64)
        tol = GRAD_TOL * lmt.rms(a)
        for g in parts:
            tol = tol + 2.0 ** -7 * np.abs(np.asarray(g[i], np.float32))
        assert (np.abs(a - t) <= tol).all(), path
    mtp = [i for i, p in enumerate(paths) if p.startswith("['mtp']")]
    assert mtp and all(np.abs(np.asarray(jg[i], np.float32)).sum() > 0
                       for i in mtp)


def test_train_step_matches_reference(monkeypatch):
    """3 steps of the config's Adafactor (bf16 update direction) from the
    same params and state, at ``test_torch_lm_train``'s tolerance for
    phi4-mini under Adafactor (the losses, every element of every leaf,
    each leaf against the reference's movement), with at most NOISE_SHARE
    of the elements at the gradient's noise floor; the router, MLA and the
    MTP head move."""
    jcfg, tcfg = configs()
    data = lmt.batches(tcfg)
    jp0 = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    grads = lmt.reference_grads(jcfg, jp0, data[0], monkeypatch)
    jp, tp, losses = lmt.train_both(jcfg, tcfg, data)
    tol = lmt.TOL[("phi4-mini-3.8b", "adafactor")]
    for a, b in losses:
        assert abs(a - b) <= tol[0] * abs(a), losses
    faults, noise = lmt.param_faults(tol, jp0, jp, tsteps.param_leaves(tp),
                                     grads)
    assert faults == [] and noise <= NOISE_SHARE, (faults, noise)
    tp0 = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp0),
                                        "cpu")
    for path in (("blocks", "moe", "w_router"), ("blocks", "mla", "wkv_b"),
                 ("mtp", "block", "mla", "wq_a")):
        a, b = tp, tp0
        for k in path:
            a, b = a[k], b[k]
        assert not torch.equal(a, b), path


def test_launch_train_script_runs_deepseek():
    """``python -m repro_torch.launch.train --arch deepseek-v3-671b
    --reduced --steps 20`` on the CPU: the loss (MTP term included)
    falls."""
    out = lmt.run_module("repro_torch.launch.train", "--arch", NAME,
                         "--reduced", "--steps", "20", "--device", "cpu")
    assert out.splitlines()[0].startswith(f"init {NAME}-reduced: L=2")
    final = [ln for ln in out.splitlines() if ln.startswith("final loss")][0]
    assert float(final.split()[2]) < float(final.split()[4][:-1])


# ---------------------------------------------------------------------------
# the top-8 combine
# ---------------------------------------------------------------------------

# bf16's unit roundoff: 8 significant bits, round to nearest
BF16_U = 2.0 ** -8


def k8_configs(**moe):
    """The reduced deepseek-v3 with the 671B config's top 8, of 16 experts,
    bf16 params and compute, its ``MoEConfig`` replaced by ``moe``."""
    cfg_j, cfg_t = configs(param_dtype="bfloat16", compute_dtype="bfloat16")
    moe = {"num_experts": 16, "top_k": 8, "capacity_factor": 1.25, **moe}
    return (dataclasses.replace(cfg_j, moe=dataclasses.replace(cfg_j.moe,
                                                               **moe)),
            dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                               **moe)))


def reference_combine(out_buf, e_s, pos, keep, t_s, p_s, T):
    """The reference's combine by its own steps
    (``repro.models.moe._moe_dispatch``): each sorted pair's output row
    (``out_buf`` (E, C, D)) times its kept probability, scatter-added to
    its token."""
    pos_c = jnp.where(keep, pos, 0)
    contrib = out_buf[e_s, pos_c] * (p_s * keep).astype(out_buf.dtype)[
        :, None]
    return jnp.zeros((T, out_buf.shape[-1]), out_buf.dtype).at[t_s].add(
        contrib)


@pytest.mark.parametrize("K", [8, 2])
def test_combine_matches_reference_bits(K):
    """The combine of ``_moe_dispatch`` alone, bf16, T 512 x D 256 over 16
    experts at cf 1.0 (some pairs dropped), on the same expert outputs
    and plan as the reference's scatter-add: bit for bit at K 8 as at
    K 2.  ``index_add_``, the port's combine before, sums a token's terms
    in float32 and rounds once: bit-equal at K 2 (one rounding either
    way), and at K 8 equal in only about half the elements (49% read),
    within the bound of two orders of a sum of K bf16 terms each add
    rounded at u = 2^-8 relative: 2 (K - 1) u sum_k |c_k| per element
    (read: 3.7 u sum_k |c_k| at worst, against 14 u)."""
    _, cfg_t = k8_configs(top_k=K, capacity_factor=1.0)
    E, D, T = 16, cfg_t.d_model, 512
    rng = np.random.default_rng(K)
    top_idx = torch.tensor(np.argsort(rng.random((T, E)), axis=1)[:, :K])
    top_p = rng.random((T, K)).astype(np.float32)
    top_p /= top_p.sum(1, keepdims=True)
    C = tmoe._capacity(cfg_t, T)
    order, e_s, pos, keep = tmoe.dispatch_plan(cfg_t, top_idx, C)
    assert not bool(keep.all())
    out_buf = np.asarray(jnp.asarray(rng.standard_normal((E, C, D)),
                                     jnp.bfloat16))
    ob = torch.tensor(out_buf.astype(np.float32)).to(torch.bfloat16)
    p_s = torch.tensor(top_p).reshape(-1)[order]
    w_s = (p_s * keep).to(torch.bfloat16)
    slot_c = e_s * C + torch.where(keep, pos, 0)
    out = tmoe.combine(ob.view(E * C, D), slot_c, w_s, order, top_idx)
    ref = reference_combine(jnp.asarray(out_buf), *(
        jnp.asarray(to_np(a)) for a in (e_s, pos, keep, order // K, p_s)), T)
    ref = np.asarray(ref, np.float32)
    assert out.dtype == torch.bfloat16
    assert np.array_equal(ref, out.float().numpy())
    contrib = ob.view(E * C, D)[slot_c] * w_s[:, None]
    summed = torch.zeros((T, D), dtype=torch.bfloat16).index_add_(
        0, order // K, contrib).float().numpy()
    total = np.zeros((T, D))
    np.add.at(total, to_np(order // K), np.abs(contrib.float().numpy()))
    if K == 2:
        assert np.array_equal(ref, summed)
    else:
        assert np.mean(ref == summed) < 0.6
        assert (np.abs(ref - summed) <= 2 * (K - 1) * BF16_U * total).all()


def test_top8_dispatch_matches_reference():
    """The MoE layer at K 8 of 16 experts, bf16, cf 1.0, B 2 x S 64: the
    same experts (the float32 router; every token's 8th / 9th probability
    gap above test_torch_moe's MIN_GAP), the same dispatch order, rows and
    kept pairs as the reference's own steps, some dropped; the output
    within test_torch_moe's BF16_DISPATCH_TOL, the tolerance of its bf16
    dispatch at K 2 (``jax.nn.silu`` rounds its sigmoid to bf16, torch's
    silu once: the expert rows differ by bf16 ulps before the combine,
    which adds no difference of its own) and the aux within
    ROUTER_TOL."""
    cfg_j, cfg_t = k8_configs(capacity_factor=1.0)
    jp = jmoe.init_moe(cfg_j, jax.random.PRNGKey(2))
    tp = {k: (v.to(torch.bfloat16) if k != "w_router" else v)
          for k, v in tree_to_torch(jax.tree.map(np.asarray, jp)).items()
          if k != "shared"}
    tp["shared"] = {k: v.to(torch.bfloat16) for k, v in tree_to_torch(
        jax.tree.map(np.asarray, jp["shared"])).items()}
    x = np.asarray(jnp.asarray(rand((2, 64, cfg_j.d_model), 16),
                               jnp.bfloat16)).astype(np.float32)
    xf = x.reshape(-1, cfg_j.d_model)
    T, K = xf.shape[0], 8
    assert min_gap(router_probs(cfg_j, jp, xf), K) > MIN_GAP
    _, i_j, _ = jmoe.router(cfg_j, jp, jnp.asarray(xf))
    _, i_t, _ = tmoe.router(cfg_t, tp, torch.tensor(xf))
    assert np.array_equal(np.asarray(i_j), to_np(i_t))
    C = tmoe._capacity(cfg_t, T)
    kept_j, counts = reference_keep(cfg_j, i_j, C)
    order, _, _, keep = tmoe.dispatch_plan(cfg_t, i_t, C)
    assert np.array_equal(np.asarray(jnp.argsort(jnp.asarray(
        np.asarray(i_j)).reshape(-1))), to_np(order))
    assert np.array_equal(kept_j, np.sort(to_np(order[keep])))
    assert counts.max() > C
    out_j, aux_j = jmoe._moe_dispatch(cfg_j, jp, jnp.asarray(
        x, jnp.bfloat16))
    out_t, aux_t = tmoe._moe_dispatch(cfg_t, tp, torch.tensor(x).to(
        torch.bfloat16))
    ref, out = np.asarray(out_j, np.float32), out_t.float().numpy()
    rel = float(np.sqrt(np.mean((ref - out) ** 2) / np.mean(ref ** 2)))
    worst = max_diff(ref, out)[0] / float(np.abs(ref).max())
    assert rel <= BF16_DISPATCH_TOL[0] and worst <= BF16_DISPATCH_TOL[1], (
        rel, worst)
    assert abs(float(aux_j) - float(aux_t)) <= ROUTER_TOL
