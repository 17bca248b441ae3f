"""Parity of the port's vision-language model with the reference: M-RoPE
(``layers.apply_rope`` with sections over (t, h, w) positions), the vision
frontend's patches in place of the first token embeddings, and
``qwen2-vl-2b`` through ``forward_train``, ``lm_loss``, ``init_cache``,
``prefill``, ``decode_step``, the serving steps and ``make_train_step``, at
``reduced()`` sizes (2 layers, D 256, 4 query heads over 2 KV heads of 64,
M-RoPE sections (12, 10, 10), qkv biases, 16 patches of 1280 for a 64-token
prompt).  The same numpy-seeded inputs go through both packages, the
reference's parameters carried over by ``convert.model_params_from_jax``
(its zero qkv biases replaced by N(0, 0.1) draws).  Everything is float32;
each test states its tolerance, and the model-level ones are
``tests/_torch_frontend.py``'s.  The reference's ``backend="pallas"``
forward runs its flash kernel in interpret mode, as its own tests run it;
the port's runs the kernel's plain twin on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import base as tbase
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from tests import _torch_frontend as fm
from tests._torch_parity import assert_close

NAME = "qwen2-vl-2b"
CACHE_LEAVES = ("k", "v")


def rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    return fm.make_case(NAME)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections,dh", [((16, 24, 24), 128),
                                         ((12, 10, 10), 64)])
def test_mrope_matches_reference_on_distinct_components(sections, dh):
    """qwen2-vl's sections at its head dim of 128 and the reduced (12, 10,
    10) at 64, theta 1e6, (t, h, w) positions drawn apart up to 4095 (as
    grid positions of patches would be): each section turned by its own
    component; the angles are the same float32 numbers, cos and sin of
    them ~1 ulp apart -> 1e-5 on unit inputs.  The result differs from
    plain RoPE by the first component, so the sections count."""
    x = rand((2, 8, 3, dh), 4)
    pos = np.random.default_rng(5).integers(0, 4096, (2, 8, 3)).astype(
        np.int32)
    assert (pos[..., 0] != pos[..., 1]).any() and \
        (pos[..., 1] != pos[..., 2]).any()
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    out = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6,
                             sections)
    assert_close(ref, out, 1e-5, "mrope")
    plain = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos[..., 0]),
                               1e6)
    assert float((plain - out).abs().max()) > 0.1
    # (B, S, 3) positions without sections rotate by the first component
    assert_close(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
                 tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6),
                 1e-5, "first component")
    with pytest.raises(ValueError, match="do not split"):
        tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6,
                           (4, 4, 4))


@pytest.mark.parametrize("sections,dh", [((16, 24, 24), 128),
                                         ((12, 10, 10), 64)])
def test_mrope_equals_rope_on_text_positions(sections, dh):
    """Text positions repeat one position as (t, h, w), as ``_positions``
    gives them: M-RoPE then equals RoPE to the bit, in the reference and
    in the port alike."""
    x = rand((2, 16, 2, dh), 6)
    pos = np.stack([np.arange(16), 4080 + np.arange(16)]).astype(np.int32)
    pos3 = np.repeat(pos[..., None], 3, axis=-1)
    for rope in (jlayers.apply_rope, lambda a, p, t, s=(): tlayers.apply_rope(
            torch.tensor(np.asarray(a)), torch.tensor(np.asarray(p)), t, s)):
        m = np.asarray(rope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections))
        r = np.asarray(rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
        assert np.array_equal(m, r)


def test_positions_are_the_text_position_three_times():
    cfg_j, cfg_t = fm.configs(NAME)
    toks = np.zeros((2, 9), np.int32)
    ref = np.asarray(jmodel._positions(cfg_j, jnp.asarray(toks)))
    out = tmodel._positions(cfg_t, torch.tensor(toks))
    assert out.shape == (2, 9, 3) and out.dtype == torch.int32
    assert np.array_equal(ref, out.numpy())


def test_apply_and_decode_attention_with_mrope_match_reference():
    """The reduced config's attention with M-RoPE and qkv biases (N(0,
    0.1)): ``apply_attention`` over 16 positions (1e-5 on O(1) outputs,
    K after M-RoPE likewise), and a ``decode_attention`` step at position
    9 of a cache of 12, whose token's (t, h, w) are its position thrice."""
    cfg_j, cfg_t = fm.configs(NAME)
    p = dict(jattn.init_attention(cfg_j, jax.random.PRNGKey(8)))
    rng = np.random.default_rng(9)
    for b in ("bq", "bk", "bv"):
        p[b] = jnp.asarray(0.1 * rng.standard_normal(p[b].shape), p[b].dtype)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    x = rand((2, 16, cfg_j.d_model), 10)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None, :, None],
                          (2, 16, 3))
    ref = jattn.apply_attention(cfg_j, p, jnp.asarray(x), jnp.asarray(pos),
                                return_kv=True)
    out = tattn.apply_attention(cfg_t, tp, torch.tensor(x),
                                torch.tensor(pos.copy()), return_kv=True)
    for r, o, what in zip(ref, out, ("out", "k", "v")):
        assert_close(r, o, 1e-5, what)
    dh = cfg_j.resolved_head_dim
    kv = rand((2, 12, cfg_j.num_kv_heads, dh), 11)
    one = x[:, :1]
    ref = jattn.decode_attention(cfg_j, p, jnp.asarray(one), jnp.asarray(kv),
                                 jnp.asarray(kv), jnp.int32(9))
    out = tattn.decode_attention(cfg_t, tp, torch.tensor(one),
                                 torch.tensor(kv), torch.tensor(kv),
                                 torch.tensor(9))
    for r, o, what in zip(ref, out, ("decode out", "cache k", "cache v")):
        assert_close(r, o, 1e-5, what)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_patches_replace_the_first_token_embeddings(case):
    """A vision prompt's 16 projected patches take the place of its first
    16 token embeddings (1e-5 on the O(1) projections), the rest are the
    tokens' rows; without embeddings the tokens' rows throughout."""
    c = case
    ref = jmodel._embed(c["cfg_j"], c["jp"], jnp.asarray(c["toks"]),
                        jnp.asarray(c["fe"]))
    out = tmodel._embed(c["cfg_t"], c["tp"], torch.tensor(c["toks"]),
                        torch.tensor(c["fe"]))
    P = c["fe"].shape[1]
    assert P == 16
    assert_close(ref, out, 1e-5, "embed")
    plain = tmodel._embed(c["cfg_t"], c["tp"], torch.tensor(c["toks"]))
    assert torch.equal(out[:, P:], plain[:, P:])
    assert not torch.equal(out[:, :P], plain[:, :P])


def test_init_params_tree_matches_reference():
    """The port's own parameters: the reference's tree (``frontend``'s
    projector, qkv biases), shapes and dtypes, full size on the meta
    device and reduced on the CPU."""
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
    assert tuple(p["frontend"]["projector"].shape) == (1280, 256)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(case, backend):
    fm.check_forward(case, backend)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_lm_loss_matches_reference(case, backend):
    fm.check_lm_loss(case, backend)


def test_init_cache_matches_reference():
    fm.check_init_cache(NAME, CACHE_LEAVES)


def test_prefill_matches_reference(case):
    fm.check_prefill(case, CACHE_LEAVES)


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


def test_synthetic_batch_equals_the_reference():
    fm.check_synthetic_batch(NAME)


def test_model_flops_and_param_count():
    """Equal to the reference's: 1.779 B params, no encoder term."""
    assert fm.check_model_flops(NAME) == 1_779_447_296


def test_launch_train_script():
    fm.check_launch_train(NAME)
