"""Parity of the port's encoder-decoder and the modality frontends with the
reference: ``models/frontend.py`` (the projector and the token counts of
both frontends), the sinusoidal positions, the gelu MLP, cross attention,
the audio encoder, and ``seamless-m4t-large-v2`` through ``forward_train``,
``lm_loss``, ``init_cache``, ``prefill``, ``decode_step``, the serving
steps and ``make_train_step``, at ``reduced()`` sizes (2 decoder and 2
encoder layers, D 256, 4 heads of 64, 8 frames of 1024 for a 64-token
prompt).  The same numpy-seeded inputs go through both packages, the
reference's parameters carried over by ``convert.model_params_from_jax``.
Everything is float32; each test states its tolerance, and the model-level
ones are ``tests/_torch_frontend.py``'s.  The reference's ``backend=
"pallas"`` forward runs its flash kernel in interpret mode, as its own
tests run it; the port's runs the kernel's plain twin on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import frontend as jfe
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import frontend as tfe
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from tests import _torch_frontend as fm
from tests._torch_parity import assert_close, to_np

NAME = "seamless-m4t-large-v2"
CACHE_LEAVES = ("k", "v", "xk", "xv")


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def case():
    return fm.make_case(NAME)


# ---------------------------------------------------------------------------
# the frontends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_num_frontend_tokens_matches_reference(frontend):
    """The frames (audio: S // 8, at least 8) or patches (vision: S // 4
    within [8, 1024]) a prompt of S tokens carries, S from 1 to 9000, and
    the constants and widths: equal as integers."""
    cfg_j = dataclasses.replace(jbase.get_config(NAME), frontend=frontend)
    cfg_t = dataclasses.replace(tbase.get_config(NAME), frontend=frontend)
    for S in list(range(1, 130)) + list(range(130, 9000, 37)) + [4096, 4160]:
        assert tfe.num_frontend_tokens(cfg_t, S) == \
            jfe.num_frontend_tokens(cfg_j, S), S
    assert tfe.frontend_dim(cfg_t) == jfe.frontend_dim(cfg_j)
    for k in ("AUDIO_FRONTEND_DIM", "VISION_FRONTEND_DIM", "AUDIO_DOWNSAMPLE",
              "VISION_PATCHES"):
        assert getattr(tfe, k) == getattr(jfe, k)
    assert tfe.num_frontend_tokens(cfg_t, 4096) == {"audio": 512,
                                                    "vision": 1024}[frontend]
    assert tfe.num_frontend_tokens(tbase.get_config("phi4-mini-3.8b"),
                                   4096) == 0


@pytest.mark.parametrize("frontend", ["audio", "vision"])
def test_frontend_project_matches_reference(frontend):
    """``init_frontend``'s tree and its projector's distribution (a normal
    cut at +-2 over sqrt(frontend_dim)), and ``project``: the reference's
    projector on N(0, 1) embeddings, 1e-5 on the O(1) outputs of a
    fan-in-scaled float32 product; ``{}`` without a frontend."""
    cfg_j = dataclasses.replace(jbase.get_config(NAME).reduced(),
                                frontend=frontend)
    cfg_t = dataclasses.replace(tbase.get_config(NAME).reduced(),
                                frontend=frontend)
    p = jfe.init_frontend(cfg_j, jax.random.PRNGKey(3))
    x = rand((2, 9, jfe.frontend_dim(cfg_j)), 4)
    ref = jfe.project(cfg_j, p, jnp.asarray(x))
    out = tfe.project(cfg_t, tree_to_torch(p), torch.tensor(x))
    assert out.shape == (2, 9, cfg_t.d_model)
    assert_close(ref, out, 1e-5, "project")
    mine = tfe.init_frontend(cfg_t, torch.Generator().manual_seed(0))
    w = mine["projector"]
    assert sorted(mine) == ["projector"]
    assert tuple(w.shape) == p["projector"].shape
    fan = tfe.frontend_dim(cfg_t) ** -0.5
    assert float(w.abs().max()) <= 2 * fan * (1 + 1e-6)
    assert abs(float(w.std()) / fan - 0.88) < 0.01
    assert tfe.init_frontend(dataclasses.replace(cfg_t, frontend=""),
                             torch.Generator()) == {}


# ---------------------------------------------------------------------------
# sinusoidal positions, the gelu MLP, cross attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [256, 1024])
def test_sinusoidal_at_matches_reference(dim):
    """Positions 0-4100 (a 1-d tensor, and a decode's 0-d tensor).  Both
    compute the frequencies exp(2i * (-log 10000 / dim)) in float32 from
    the same exponents, but XLA's float32 exp is one ulp off the
    correctly rounded value at 15 of the 128 frequencies of dim 256 where
    torch's is at 3, so the frequencies are held to one ulp, and at
    position p an ulp of a frequency (at most 2^-23 below 1) turns the
    angle by up to p 2^-23: each value within 1e-6 + p 2^-23 (4.9e-4 at
    p = 4100; sin and cos of the same angle agree to ~1 ulp)."""
    pos = np.arange(4101, dtype=np.int32)
    ref = np.asarray(jlayers.sinusoidal_at(jnp.asarray(pos), dim))
    out = tlayers.sinusoidal_at(torch.tensor(pos), dim)
    assert out.dtype == torch.float32 and out.shape == (4101, dim)
    # the frequencies: the odd column of position 1 is cos(f), so read f
    # from position 1's angle, sin(f) at the even column, through arcsin
    f_ref = np.arcsin(ref[1, 0::2].astype(np.float64))
    f_out = np.arcsin(to_np(out)[1, 0::2].astype(np.float64))
    assert (np.abs(f_ref - f_out) <= 2.0 ** -23 * np.abs(f_ref) + 1e-7).all()
    err = np.abs(ref - to_np(out)).max(axis=1)
    assert (err <= 1e-6 + pos * 2.0 ** -23).all(), float(err.max())
    one = tlayers.sinusoidal_at(torch.tensor(4097), dim)
    assert one.shape == (dim,)
    assert_close(jlayers.sinusoidal_at(jnp.int32(4097), dim), one,
                 1e-6 + 4097 * 2.0 ** -23, "0-d")


@pytest.mark.parametrize("seq,dim", [(8, 256), (512, 1024), (33, 64)])
def test_sinusoidal_positions_bit_equal(seq, dim):
    """The encoder's table: numpy float64 cast to float32 in both, so
    equal to the bit."""
    ref = np.asarray(jlayers.sinusoidal_positions(seq, dim))
    out = tlayers.sinusoidal_positions(seq, dim)
    assert out.dtype == torch.float32
    assert np.array_equal(ref, out.numpy())


def test_gelu_mlp_matches_reference():
    """``apply_mlp`` for activation "gelu": the tanh approximation
    (``jax.nn.gelu``'s default): 1e-5 on the O(1) outputs; the exact erf
    form would sit ~1.5e-4 away at 1.0."""
    cfg_j = jbase.get_config(NAME).reduced()
    cfg_t = tbase.get_config(NAME).reduced()
    assert cfg_t.activation == "gelu"
    p = jlayers.init_mlp(cfg_j, jax.random.PRNGKey(0), 32, 48)
    assert sorted(p) == ["w1", "w2"]
    x = rand((2, 5, 32), 5, 2.0)
    ref = jlayers.apply_mlp(cfg_j, p, jnp.asarray(x))
    out = tlayers.apply_mlp(cfg_t, tree_to_torch(p), torch.tensor(x))
    assert_close(ref, out, 1e-5, "gelu mlp")
    mine = tlayers.init_mlp(cfg_t, torch.Generator().manual_seed(0), 32, 48)
    assert sorted(mine) == ["w1", "w2"]
    assert abs(float(torch.nn.functional.gelu(torch.tensor(1.0),
                                              approximate="tanh"))
               - float(jax.nn.gelu(1.0))) < 1e-7


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_apply_cross_attention_matches_reference(kv_heads):
    """Queries of 7 decoder positions over 9 encoder positions, 4 heads
    over ``kv_heads``, no mask, no RoPE, and no bias although the config
    asks for qkv biases (the reference's cross attention ignores them):
    1e-5 on O(1) outputs; ``cross_kv`` is the K / V the decode cache
    keeps."""
    changes = {"num_kv_heads": kv_heads, "qkv_bias": True}
    cfg_j = dataclasses.replace(jbase.get_config(NAME).reduced(), **changes)
    cfg_t = dataclasses.replace(tbase.get_config(NAME).reduced(), **changes)
    p = dict(jattn.init_attention(cfg_j, jax.random.PRNGKey(6)))
    for b in ("bq", "bk", "bv"):
        p[b] = jnp.ones_like(p[b])
    x, src = rand((2, 7, cfg_j.d_model), 7), rand((2, 9, cfg_j.d_model), 8)
    ref = jattn.apply_cross_attention(cfg_j, p, jnp.asarray(x),
                                      jnp.asarray(src))
    tp = tree_to_torch(p)
    out = tattn.apply_cross_attention(cfg_t, tp, torch.tensor(x),
                                      torch.tensor(src))
    assert out.shape == (2, 7, cfg_t.d_model)
    assert_close(ref, out, 1e-5, "cross attention")
    k, v = tattn.cross_kv(cfg_t, tp, torch.tensor(src))
    dh = cfg_t.resolved_head_dim
    assert_close((src @ np.asarray(p["wk"])).reshape(2, 9, kv_heads, dh), k,
                 1e-5, "xk")
    assert_close((src @ np.asarray(p["wv"])).reshape(2, 9, kv_heads, dh), v,
                 1e-5, "xv")


def test_encoder_matches_reference(case):
    """``_run_encoder`` on 8 frames: the projector, the sinusoidal table,
    2 non-causal blocks and the final norm, 1e-5 on its O(1) output."""
    ref = jmodel._run_encoder(case["cfg_j"], case["jp"],
                              jnp.asarray(case["fe"]))
    out = tmodel._run_encoder(case["cfg_t"], case["tp"],
                              torch.tensor(case["fe"]))
    assert out.shape == (2, 8, case["cfg_t"].d_model)
    assert_close(ref, out, 1e-5, "encoder")


def test_encoder_never_reaches_the_flash_kernel(case, monkeypatch):
    """``backend="pallas"``: the flash kernel's wrapper is called once a
    decoder layer and never by the encoder, whose non-causal attention
    runs the dense ``gqa_attend`` whatever the backend, as in the
    reference."""
    calls = []
    real = tattn.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    c = case
    tmodel._run_encoder(c["cfg_t"], c["tp"], torch.tensor(c["fe"]))
    assert calls == []
    tmodel.forward_train(c["cfg_t"], c["tp"], torch.tensor(c["toks"]),
                         torch.tensor(c["fe"]), backend="pallas")
    assert len(calls) == c["cfg_t"].num_layers


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference():
    """The port's own parameters: the reference's tree (``encoder`` with
    its blocks and final norm, ``frontend``'s projector, ``ln_c`` and
    ``cross`` in the decoder's blocks, LayerNorm biases), shapes and
    dtypes, full size on the meta device and reduced on the CPU."""
    for cfg_j, cfg_t, dev in (
            (jbase.get_config(NAME), tbase.get_config(NAME), "meta"),
            (*fm.configs(NAME), "cpu")):
        shapes = jax.eval_shape(lambda: jmodel.init_params(
            cfg_j, jax.random.PRNGKey(0)))
        p = tmodel.init_params(cfg_t, seed=1, device=dev)
        ref_leaves = jax.tree_util.tree_leaves_with_path(shapes)
        out_leaves = jax.tree_util.tree_leaves_with_path(p)
        assert [k for k, _ in ref_leaves] == [k for k, _ in out_leaves]
        for (k, r), (_, o) in zip(ref_leaves, out_leaves):
            assert tuple(r.shape) == tuple(o.shape), k
            assert o.dtype == tmodel.dtype_of(np.dtype(r.dtype).name), k
    assert "cross" in p["blocks"] and "ln_c" in p["blocks"]
    assert "cross" not in p["encoder"]["blocks"]


def test_model_params_from_jax_checks_the_encoder_depth(case):
    """The encoder's stacked depth must be the config's
    ``encoder_layers``: a tree with one encoder layer cut, or none, is
    refused with ValueError, as a wrong decoder depth is."""
    tree = jax.tree.map(np.asarray, case["jp"])
    cut = {**tree, "encoder": {**tree["encoder"], "blocks": jax.tree.map(
        lambda a: a[:1], tree["encoder"]["blocks"])}}
    with pytest.raises(ValueError, match="1 stacked encoder layers"):
        convert.model_params_from_jax(case["cfg_t"], cut, device="cpu")
    gone = {k: v for k, v in tree.items() if k != "encoder"}
    with pytest.raises(ValueError, match="0 stacked encoder layers"):
        convert.model_params_from_jax(case["cfg_t"], gone, device="cpu")
    out = convert.model_params_from_jax(case["cfg_t"], tree, device="cpu")
    assert tmodel.stack_depth(out["encoder"]["blocks"]) == 2


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(case, backend):
    fm.check_forward(case, backend)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_lm_loss_matches_reference(case, backend):
    fm.check_lm_loss(case, backend)


def test_decoder_positions_are_sinusoidal(case):
    """``rope_kind == "none"``: the decoder's input is the embedding plus
    the sinusoidal rows, from 0 and from a decode's device position,
    within the tolerance of ``test_sinusoidal_at_matches_reference`` at
    the last position (1e-6 + p 2^-23)."""
    c = case
    for toks, off in ((c["toks"], 0), (c["toks"][:, :1], 70)):
        ref = jmodel._embed(c["cfg_j"], c["jp"], jnp.asarray(toks),
                            pos_offset=jnp.int32(off))
        out = tmodel._embed(c["cfg_t"], c["tp"], torch.tensor(toks),
                            pos_offset=torch.tensor(off))
        last = off + toks.shape[1] - 1
        assert_close(ref, out, 1e-6 + last * 2.0 ** -23, f"embed at {off}")


def test_init_cache_matches_reference():
    fm.check_init_cache(NAME, CACHE_LEAVES)


def test_prefill_matches_reference(case):
    fm.check_prefill(case, CACHE_LEAVES)


def test_prefill_sizes_the_cross_cache_from_the_prompt(case):
    """A quirk of the reference kept: ``init_cache`` sizes the cross K / V
    from its length (67 positions: 8 frames), ``prefill`` from the
    prompt's frames, here 16 for a prompt of 64 tokens carrying 128 frames'
    worth: the two differ, in both packages alike."""
    c = case
    fe = fm.embeds(c["cfg_j"], 2, 128, 3)
    _, cache_j = jmodel.prefill(c["cfg_j"], c["jp"], jnp.asarray(c["toks"]),
                                cache_len=67, frontend_embeds=jnp.asarray(fe))
    _, cache_t = tmodel.prefill(c["cfg_t"], c["tp"], torch.tensor(c["toks"]),
                                cache_len=67, frontend_embeds=torch.tensor(fe))
    fm.hold_cache(cache_j, cache_t, "16 frames")
    assert cache_t["xk"].shape[2] == 16
    assert tmodel.init_cache(c["cfg_t"], 2, 67, device="cpu")["xk"].shape[2] \
        == jax.eval_shape(lambda: jmodel.init_cache(c["cfg_j"], 2, 67)
                          )["xk"].shape[2] == 8


def test_decode_matches_reference(case):
    fm.check_decode(case)


def test_prefill_decode_consistency():
    fm.check_consistency(NAME)


def test_serving_steps_equal_the_direct_calls():
    fm.check_prefill_step(NAME)


def test_train_step_matches_reference(monkeypatch):
    fm.check_train_step(NAME, monkeypatch)


def test_train_step_cuts_the_frontend_embeds_with_the_tokens(monkeypatch):
    fm.check_microbatch_split(NAME, monkeypatch)


def test_remat_full_gradients_equal_no_remat():
    """``remat == "full"`` checkpoints every block, encoder and decoder
    (the decoder's with the encoder output as a keyword input): the loss
    and every gradient, the encoder's included, equal to the bit to the
    run without it."""
    _, cfg = fm.configs(NAME)
    p = tmodel.init_params(cfg, seed=2, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.tensor(rng.integers(0, 512, (2, 16))),
             "labels": torch.tensor(rng.integers(0, 512, (2, 16))),
             "frontend_embeds": torch.tensor(fm.embeds(cfg, 2, 16, 4))}
    leaves = tsteps.param_leaves(p)
    out = []
    for remat in ("", "full"):
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = tmodel.lm_loss(dataclasses.replace(cfg, remat=remat), p,
                                 batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
        for x in leaves:
            x.requires_grad_(False)
    assert torch.equal(out[0][0], out[1][0])
    paths = [k for k, _ in tsteps.leaves_with_paths(p)]
    for path, a, b in zip(paths, out[0][1], out[1][1]):
        assert torch.equal(a, b), path
    assert any(path.startswith("encoder/") and bool(g.abs().sum() > 0)
               for path, g in zip(paths, out[0][1]))


def test_synthetic_batch_equals_the_reference():
    fm.check_synthetic_batch(NAME)


def test_model_flops_and_param_count():
    """Equal to the reference's; the encoder's 0.503 B of 1.633 B params
    count over the frontend's frames (512 at train_4k's 4096 tokens)."""
    assert fm.check_model_flops(NAME) == 1_633_406_976


def test_launch_train_script():
    fm.check_launch_train(NAME)


def test_check_supported_names_what_it_refuses():
    """An encoder-decoder without the audio frontend (the reference's
    encoder reads its frames) or over a mixer other than GQA attention
    (the reference's prefill fills the cross cache in its GQA branch) is
    refused by name at the entry points; the reduced config is accepted."""
    _, cfg = fm.configs(NAME)
    tmodel.check_supported(cfg)
    for changes, what in (({"frontend": ""}, "without the audio frontend"),
                          ({"frontend": "vision"},
                           "without the audio frontend"),
                          ({"frontend": "video"}, "frontend 'video'"),
                          ({"attention_kind": "mla",
                            "mla": tbase.MLAConfig(q_lora_rank=64,
                                                   kv_lora_rank=32)},
                           "over attention_kind 'mla'")):
        bad = dataclasses.replace(cfg, **changes)
        for call in (lambda: tmodel.init_params(bad, device="cpu"),
                     lambda: tmodel.init_cache(bad, 1, 4, device="cpu")):
            with pytest.raises(NotImplementedError, match=what):
                call()
    assert to_np(tmodel.init_cache(cfg, 1, 4, device="cpu")["xk"]).shape == \
        (2, 1, 8, 4, 64)
