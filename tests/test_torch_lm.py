"""Parity of the port's language-model path with the reference: configs,
layers, attention, RWKV-6, the plain versions of the flash-attention and
WKV6 kernels, and ``forward_train`` / ``lm_loss`` of the reduced
``phi4-mini-3.8b`` and ``rwkv6-3b`` through ``model_params_from_jax``.

The reference runs on the CPU as its own tests run it: its Pallas kernels
in interpret mode.  Everything here is float32 unless a test says
otherwise; the two frameworks round in different places (XLA fusion and
another summation order against PyTorch op by op), so float32 results agree
to a few ulp of their scale, and each tolerance says what it covers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.flash_attention import kernel as jflash_kernel
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.rwkv6 import kernel as jwkv_kernel
from repro.kernels.rwkv6 import ops as jwkv
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rwkv6 import ops as twkv
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from tests._torch_parity import assert_close, max_diff, to_np

NAMES = ("phi4-mini-3.8b", "rwkv6-3b")


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _decay(shape, seed=0):
    """Decays as the RWKV-6 layer makes them: exp(-exp(w0 + d)) with the
    configs' w0 = -6 and a data term d ~ N(0, 0.5)."""
    d = np.random.default_rng(seed).standard_normal(shape)
    return np.exp(-np.exp(-6.0 + 0.5 * d)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(name):
    """The port's copy of the two configs, full and reduced, field by
    field; the padded vocabularies are 200192 and 65536."""
    ref, out = jbase.get_config(name), tbase.get_config(name)
    assert dataclasses.asdict(ref) == dataclasses.asdict(out)
    assert dataclasses.asdict(ref.reduced()) == dataclasses.asdict(
        out.reduced())
    assert out.vocab_padded == ref.vocab_padded
    assert out.resolved_head_dim == ref.resolved_head_dim
    assert {"phi4-mini-3.8b": 200192, "rwkv6-3b": 65536}[name] == \
        out.vocab_padded
    assert ({k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jbase.INPUT_SHAPES.items()})


def test_registry_holds_the_ported_configs():
    assert tbase.list_configs() == sorted(NAMES)
    with pytest.raises(KeyError, match="unknown arch"):
        tbase.get_config("llama3-405b")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_apply_norm_matches_reference(name):
    """RMSNorm (phi4-mini) and LayerNorm (rwkv6) in float32: 1e-5 on
    unit-scale outputs."""
    cfg_j, cfg_t = jbase.get_config(name), tbase.get_config(name)
    x = _rand((2, 5, 64), 1, 3.0)
    p = {"scale": _rand((64,), 2), "bias": _rand((64,), 3)}
    ref = jlayers.apply_norm(cfg_j, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    out = tlayers.apply_norm(cfg_t, {k: _t(v) for k, v in p.items()}, _t(x))
    assert_close(ref, out, 1e-5, cfg_j.norm)


def test_apply_rope_matches_reference():
    """Positions up to 4095 at theta 1e4: the angles are the same float32
    numbers, cos and sin of them agree to ~1 ulp -> 1e-5 on unit inputs."""
    x = _rand((2, 8, 3, 64), 4)
    pos = np.stack([np.arange(8), 4088 + np.arange(8)]).astype(np.int32)
    ref = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    out = tlayers.apply_rope(_t(x), torch.tensor(pos), 10_000.0)
    assert_close(ref, out, 1e-5, "rope")


@pytest.mark.parametrize("name", NAMES)
def test_apply_mlp_matches_reference(name):
    """SwiGLU (phi4-mini) and the squared-relu FFN (rwkv6): 1e-5 on the
    O(1) outputs of fan-in-scaled weights."""
    cfg_j = jbase.get_config(name).reduced()
    cfg_t = tbase.get_config(name).reduced()
    p = jlayers.init_mlp(cfg_j, jax.random.PRNGKey(0), 32, 48)
    x = _rand((2, 5, 32), 5)
    ref = jlayers.apply_mlp(cfg_j, p, jnp.asarray(x))
    out = tlayers.apply_mlp(cfg_t, {k: _t(v) for k, v in p.items()}, _t(x))
    assert_close(ref, out, 1e-5, cfg_j.activation)


def test_init_params_shapes_and_distributions():
    """The port draws its own random parameters (torch.Generator): the same
    tree, shapes and dtypes as the reference's, and the reference's
    distributions: embeddings N(0, 0.02), dense weights a normal cut at
    +-2 times 1/sqrt(fan_in)."""
    cfg_t = dataclasses.replace(tbase.get_config("phi4-mini-3.8b").reduced(),
                                param_dtype="bfloat16")
    cfg_j = dataclasses.replace(jbase.get_config("phi4-mini-3.8b").reduced(),
                                param_dtype="bfloat16")
    shapes = jax.eval_shape(lambda: jmodel.init_params(
        cfg_j, jax.random.PRNGKey(0)))
    p = tmodel.init_params(cfg_t, seed=3, device="cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(shapes)
    out_leaves = jax.tree_util.tree_leaves_with_path(p)
    assert [k for k, _ in ref_leaves] == [k for k, _ in out_leaves]
    for (k, r), (_, o) in zip(ref_leaves, out_leaves):
        assert tuple(r.shape) == tuple(o.shape), k
        assert o.dtype == torch.bfloat16, k
    emb = p["embed"].float()
    assert abs(float(emb.std()) - 0.02) < 1e-3
    w1 = p["blocks"]["ffn"]["w1"].float()         # fan-in d_model = 256
    assert float(w1.abs().max()) <= 2.0 / 16.0 * (1 + 2 ** -8)
    assert abs(float(w1.std()) - 0.88 / 16.0) < 2e-3
    again = tmodel.init_params(cfg_t, seed=3, device="cpu")
    assert torch.equal(again["embed"], p["embed"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 96])
def test_gqa_and_chunked_attend_match_reference(window):
    """Dense GQA attention (4 query heads over 2 KV heads) and its
    query-chunked form at S=256, chunk 64 (4 chunks): 1e-5 on O(1)
    outputs."""
    q, k, v = (_rand((2, 256, h, 32), s) for s, h in ((6, 4), (7, 2), (8, 2)))
    ref = jattn.chunked_gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), sliding_window=window,
                                   chunk=64)
    out = tattn.chunked_gqa_attend(_t(q), _t(k), _t(v),
                                   sliding_window=window, chunk=64)
    assert_close(ref, out, 1e-5, "chunked")
    whole = tattn.gqa_attend(_t(q), _t(k), _t(v),
                             tattn.causal_mask(256, 256, window))
    assert_close(ref, whole, 1e-5, "one chunk")
    assert np.array_equal(to_np(jattn.causal_mask(5, 9, 3)),
                          to_np(tattn.causal_mask(5, 9, 3)))


@pytest.mark.parametrize("causal", [True, False])
def test_apply_attention_matches_reference(causal):
    """Projections, RoPE, dense attention (causal, or unmasked as the
    reference's encoder uses it) and the output projection of the reduced
    phi4-mini with 2 KV heads; return_kv gives the post-RoPE K and V.
    1e-5 on O(1) outputs."""
    changes = {"num_kv_heads": 2}
    cfg_j = dataclasses.replace(jbase.get_config("phi4-mini-3.8b").reduced(),
                                **changes)
    cfg_t = dataclasses.replace(tbase.get_config("phi4-mini-3.8b").reduced(),
                                **changes)
    p = jattn.init_attention(cfg_j, jax.random.PRNGKey(3))
    x = _rand((2, 16, cfg_j.d_model), 15)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    ref = jattn.apply_attention(cfg_j, p, jnp.asarray(x), jnp.asarray(pos),
                                causal=causal, return_kv=True)
    out = tattn.apply_attention(cfg_t, {k: _t(v) for k, v in p.items()},
                                _t(x), torch.tensor(pos), causal=causal,
                                return_kv=True)
    for name, a, b in zip(("out", "k", "v"), ref, out):
        assert_close(a, b, 1e-5, name)


# (B, S, H, Hkv, dh, causal, window)
FLASH_CASES = [(2, 64, 4, 2, 32, True, 0), (1, 256, 4, 2, 32, True, 0),
               (1, 256, 4, 2, 32, True, 96), (2, 64, 4, 4, 16, True, 24),
               (1, 128, 2, 1, 32, False, 0)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_reference_kernel(case):
    """The flash kernel's plain version against the reference's Pallas
    kernel (interpret mode): causal, sliding window, GQA 4 over 2, S 64 and
    256.  Online against naive softmax: ~1e-7 on O(1) outputs -> 1e-5."""
    B, S, H, Hkv, dh, causal, window = case
    q, k, v = (_rand((B, S, h, dh), s) for s, h in ((9, H), (10, Hkv),
                                                     (11, Hkv)))
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 sliding_window=window)
    out = tflash.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                 sliding_window=window)
    assert_close(ref, out, 1e-5, "flash_attention")
    # the (BH, S, dh) kernel itself against attention_ref, heads repeated
    rep = H // Hkv

    def bh(x, r=1):
        x = np.repeat(x, r, axis=2)
        return x.transpose(0, 2, 1, 3).reshape(B * H, S, dh)

    bq = min(128, S)
    kern = jflash_kernel.flash_attention_bhsd(
        jnp.asarray(bh(q)), jnp.asarray(bh(k, rep)), jnp.asarray(bh(v, rep)),
        causal=causal, sliding_window=window, block_q=bq, block_k=bq,
        interpret=True)
    plain = tflash.attention_ref(_t(bh(q)), _t(bh(k, rep)), _t(bh(v, rep)),
                                 causal=causal, sliding_window=window)
    assert_close(kern, plain, 1e-5, "attention_ref")


def test_flash_plain_bfloat16_matches_reference_kernel():
    """bfloat16 in and out: the reference kernel rounds p to bf16 at the
    running max, the plain version after normalising, and both round the
    output to bf16 (2^-8 relative): a few bf16 ulp at |o| <= 2 -> 3e-2."""
    q, k, v = (_rand((1, 128, h, 32), s) for s, h in ((12, 4), (13, 2),
                                                      (14, 2)))
    ref = jflash.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)))
    out = tflash.flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    assert out.dtype == torch.bfloat16
    assert_close(np.asarray(ref, np.float32), out.float(), 3e-2, "bf16")


def _worst_row(ref, out):
    """The largest max |out - ref| of a row over max |ref| of that row."""
    ref, out = to_np(ref).astype(np.float64), to_np(out).astype(np.float64)
    assert ref.shape == out.shape, (ref.shape, out.shape)
    d = np.abs(out - ref).max(-1)
    return float((d / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


# (B, S, H, Hkv, dh, causal, window): a 40-key tile (S < 128, not a
# multiple of 16), S = 96 under a window, a window across the 128-key tile
# edge, non-causal, dh 64; GQA 4 over 2 and 4 over 1
TILED_CASES = [(1, 40, 4, 2, 32, True, 0), (2, 96, 4, 1, 32, True, 24),
               (1, 256, 4, 2, 32, True, 96), (1, 256, 2, 2, 32, False, 0),
               (1, 256, 4, 2, 64, True, 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TILED_CASES)
def test_flash_tiled_matches_reference_kernel(case, dtype):
    """flash_attention_tiled, the card kernels' oracle, against the
    reference's Pallas kernel (interpret mode) through its wrapper, same
    inputs.  Both walk the same key tiles and round p at the same running
    max.  float32: only the order of the sums differs, ~5e-7 of a row's
    largest |o| -> 2e-6.  bfloat16: the two fp32 results differ as in
    float32, so a bf16 output differs by at most one rounding step, at
    most one ulp of the row's largest |o| (2^-7 of it)."""
    B, S, H, Hkv, dh, causal, window = case
    rng = np.random.default_rng(S + dh)
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    ref = jflash.flash_attention(
        *(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
        causal=causal, sliding_window=window)
    out = tflash.flash_attention_tiled(
        *(_t(a, getattr(torch, dtype)) for a in (q, k, v)), causal=causal,
        sliding_window=window)
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    err = _worst_row(np.asarray(ref, np.float32), out.float())
    assert err <= (2e-6 if dtype == "float32" else 2 ** -7), err


def test_flash_smem_bytes_per_kernel():
    """Each kernel's shared memory, as its launch checks it on the card:
    bf16, the 1024-byte alignment slack, Q and a 2-stage K/V ring of
    128-row bf16 tiles and 7 barriers, at least 120 KB (one block per SM);
    float32, the CUDA-core kernel's 64 padded query rows, K, V and p
    tiles."""
    from repro_torch.kernels import SMEM_PER_BLOCK
    assert tflash.smem_bytes(128, torch.bfloat16) == 1024 + 5 * 32768 + 56
    assert tflash.smem_bytes(32, torch.bfloat16) == 120 * 1024
    assert tflash.smem_bytes(128, torch.float32) == 198_144
    for dh in tflash.KERNEL_DH:
        for dtype in (torch.bfloat16, torch.float32):
            assert tflash.smem_bytes(dh, dtype) <= SMEM_PER_BLOCK


def test_flash_checks_shapes():
    q = torch.zeros((1, 64, 3, 16))
    kv = torch.zeros((1, 64, 2, 16))
    with pytest.raises(ValueError, match="do not group"):
        tflash.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tflash.flash_attention_cuda(kv, kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tflash.flash_attention_cuda(kv.half(), kv.half(), kv.half())


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, N, seed):
    r, k, v = (_rand((B, S, H, N), seed + i) for i in range(3))
    return (r, k, v, _decay((B, S, H, N), seed + 3),
            _rand((H, N), seed + 4, 0.1), _rand((B, H, N, N), seed + 5, 0.1))


# (B, S, H, N): chunks of 32, of 25 (100 = 4 x 25) and a single chunk of 16
WKV_CASES = [(2, 64, 2, 16), (1, 100, 2, 32), (1, 16, 3, 8)]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_plain_matches_reference_kernel(case):
    """The WKV6 kernel's plain version (the sequential recurrence) against
    the reference's chunked Pallas kernel and its wrapper.  The chunked
    algebra reassociates the recurrence: ~1e-6 of the output's scale ->
    1e-5 relative to the largest |out|, the state likewise."""
    B, S, H, N = case
    r, k, v, w, u, s0 = _wkv_inputs(B, S, H, N, sum(case))
    ref, s_ref = jwkv.wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    out, s_out = twkv.wkv6(*(_t(a) for a in (r, k, v, w, u, s0)))
    scale = float(np.abs(to_np(ref)).max())
    assert max_diff(ref, out)[0] <= 1e-5 * scale
    assert max_diff(s_ref, s_out)[0] <= 1e-5 * float(np.abs(s_ref).max())
    # the (BH, S, N) kernel itself against wkv6_ref
    C = twkv.pick_chunk(S)

    def bh(x):
        return x.transpose(0, 2, 1, 3).reshape(B * H, S, N)

    ub = np.broadcast_to(u[None], (B, H, N)).reshape(B * H, 1, N)
    args = (bh(r), bh(k), bh(v), bh(w), ub, s0.reshape(B * H, N, N))
    kern, s_kern = jwkv_kernel.wkv6_bhsn(*(jnp.asarray(a) for a in args),
                                         chunk=C, interpret=True)
    plain, s_plain = twkv.wkv6_ref(*(_t(a) for a in args))
    assert max_diff(kern, plain)[0] <= 1e-5 * scale
    assert max_diff(s_kern, s_plain)[0] <= 1e-5 * float(np.abs(s_ref).max())


def test_wkv6_bfloat16_rounds_the_decay_like_the_reference():
    """bfloat16 inputs: the wrapper casts w (a float32 decay near 0.9975) to
    bf16 before the recurrence, as the reference's does; without that cast
    the final state differs by ~6e-3 of its scale at S=64.  With it both
    compute the same float32 recurrence on the same values: the float32
    state to 1e-5 of its scale, the bf16 output within one rounding step,
    at most one ulp of its largest value (2^-7 of it)."""
    r, k, v, w, u, s0 = _wkv_inputs(1, 64, 2, 16, 20)
    bf = jnp.bfloat16
    ref, s_ref = jwkv.wkv6(jnp.asarray(r, bf), jnp.asarray(k, bf),
                           jnp.asarray(v, bf), jnp.asarray(w),
                           jnp.asarray(u, bf), jnp.asarray(s0))
    out, s_out = twkv.wkv6(_t(r, torch.bfloat16), _t(k, torch.bfloat16),
                           _t(v, torch.bfloat16), _t(w),
                           _t(u, torch.bfloat16), _t(s0))
    assert out.dtype == torch.bfloat16 and s_out.dtype == torch.float32
    ref32 = np.asarray(ref, np.float32)
    assert max_diff(ref32, out.float())[0] <= 2 ** -7 * np.abs(ref32).max()
    s_ref = np.asarray(s_ref)
    assert max_diff(s_ref, s_out)[0] <= 1e-5 * np.abs(s_ref).max()


@pytest.mark.parametrize("S", [64, 192])
def test_wkv6_chunked_and_scan_match_reference(S):
    """The reference backend's recurrences: the sequential scan (float32
    decay) and the 64-token chunked form (decay rounded to r's dtype) at
    S=192 (3 chunks); S=64 is one chunk, where the chunked form is the
    scan.  1e-5 relative to the largest |out|."""
    r, k, v, w, u, s0 = _wkv_inputs(2, S, 2, 16, S)
    for jfn, tfn in ((jssm.wkv6_scan, tssm.wkv6_scan),
                     (jssm.wkv6_chunked, tssm.wkv6_chunked)):
        ref, s_ref = jfn(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
        out, s_out = tfn(*(_t(a) for a in (r, k, v, w, u, s0)))
        scale = float(np.abs(to_np(ref)).max())
        assert max_diff(ref, out)[0] <= 1e-5 * scale, jfn.__name__
        assert max_diff(s_ref, s_out)[0] <= 1e-5 * float(
            np.abs(to_np(s_ref)).max()), jfn.__name__


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_rwkv_time_and_channel_mix_match_reference(backend):
    """One time mix (projection, decay, WKV6, group norm, gate) and one
    channel mix of the reduced rwkv6 at S=128 (the chunked reference path):
    1e-5 on O(1) outputs, the state to 1e-5 of its scale."""
    cfg_j = jbase.get_config("rwkv6-3b").reduced()
    cfg_t = tbase.get_config("rwkv6-3b").reduced()
    kt, kc = jax.random.split(jax.random.PRNGKey(1))
    pt = jssm.init_rwkv_tmix(cfg_j, kt)
    pc = jssm.init_rwkv_cmix(cfg_j, kc)
    D, H, N = cfg_j.d_model, cfg_j.num_heads, cfg_j.ssm.head_dim
    x, xp = _rand((2, 128, D), 30), _rand((2, D), 31)
    s0 = _rand((2, H, N, N), 32, 0.1)
    ref = jssm.apply_rwkv_tmix(cfg_j, pt, jnp.asarray(x), jnp.asarray(xp),
                               jnp.asarray(s0), backend=backend)
    out = tssm.apply_rwkv_tmix(cfg_t, {k: _t(v) for k, v in pt.items()},
                               _t(x), _t(xp), _t(s0), backend=backend)
    assert_close(ref[0], out[0], 1e-5, "tmix out")
    assert_close(ref[1], out[1], 0.0, "tmix x_last")
    assert max_diff(ref[2], out[2])[0] <= 1e-5 * float(np.abs(ref[2]).max())
    ref_c = jssm.apply_rwkv_cmix(cfg_j, pc, jnp.asarray(x), jnp.asarray(xp))
    out_c = tssm.apply_rwkv_cmix(cfg_t, {k: _t(v) for k, v in pc.items()},
                                 _t(x), _t(xp))
    assert_close(ref_c[0], out_c[0], 1e-5, "cmix out")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MODEL_CASES = {
    "phi4-mini": ("phi4-mini-3.8b", {}, 64),
    # reduced() gives phi4-mini H = Hkv = 4; Hkv = 2 exercises the mapping
    "phi4-mini-gqa": ("phi4-mini-3.8b", {"num_kv_heads": 2}, 64),
    "rwkv6": ("rwkv6-3b", {}, 64),
    "rwkv6-s128": ("rwkv6-3b", {}, 128),    # the chunked reference path
}


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def model_case(request):
    name, changes, S = MODEL_CASES[request.param]
    cfg_j = dataclasses.replace(jbase.get_config(name).reduced(), **changes)
    cfg_t = dataclasses.replace(tbase.get_config(name).reduced(), **changes)
    params = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg_j.vocab_size, (2, S)).astype(np.int32)
    labels = rng.integers(0, cfg_j.vocab_size, (2, S)).astype(np.int32)
    tree = jax.tree.map(np.asarray, params)
    return (cfg_j, cfg_t, params,
            convert.model_params_from_jax(cfg_t, tree, device="cpu"),
            toks, labels)


# logits of the reduced models are O(1) (0.02-scale embedding and head);
# 2 layers of float32 matmuls, norms and softmax/recurrence -> ~5e-6 seen,
# 2e-5 allowed; the loss (a mean of ~6) to 1e-5
LOGIT_ATOL, LOSS_ATOL = 2e-5, 1e-5


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_forward_train_matches_reference(model_case, backend):
    cfg_j, cfg_t, jp, tp, toks, _ = model_case
    ref, aux_ref = jmodel.forward_train(cfg_j, jp, jnp.asarray(toks),
                                        backend=backend)
    out, aux = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                    backend=backend)
    assert out.dtype == torch.float32
    assert out.shape == (2, toks.shape[1], cfg_t.vocab_padded)
    assert_close(ref, out, LOGIT_ATOL, f"{cfg_t.name} {backend} logits")
    assert float(aux) == float(aux_ref) == 0.0


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_lm_loss_matches_reference(model_case, backend):
    """The loss, plain and masked (the second half of each sequence)."""
    cfg_j, cfg_t, jp, tp, toks, labels = model_case
    mask = np.zeros(toks.shape, np.float32)
    mask[:, toks.shape[1] // 2:] = 1.0
    for m in (None, mask):
        jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(labels)}
        if m is not None:
            jb["mask"], tb["mask"] = jnp.asarray(m), torch.tensor(m)
        ref, parts_ref = jmodel.lm_loss(cfg_j, jp, jb, backend=backend)
        out, parts = tmodel.lm_loss(cfg_t, tp, tb, backend=backend)
        assert abs(float(ref) - float(out)) <= LOSS_ATOL, (m is None)
        assert abs(float(parts_ref["loss"]) - float(parts["loss"])) <= \
            LOSS_ATOL


def test_backends_agree_in_the_port(model_case):
    """The port's two backends on the same params: the plain kernels'
    versions and the reference mixers compute one function."""
    _, cfg_t, _, tp, toks, _ = model_case
    a, _ = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                backend="reference")
    b, _ = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                backend="pallas")
    assert_close(a, b, LOGIT_ATOL, "reference vs pallas")
    with pytest.raises(ValueError, match="unknown model backend"):
        tmodel.forward_train(cfg_t, tp, torch.tensor(toks), backend="tpu")


def test_token_nll_is_logsumexp_minus_gold():
    """The gather form equals the reference's one-hot contraction."""
    cfg_j = jbase.get_config("rwkv6-3b").reduced()
    cfg_t = tbase.get_config("rwkv6-3b").reduced()
    logits = _rand((2, 7, cfg_t.vocab_padded), 40, 3.0)
    labels = np.random.default_rng(41).integers(
        0, cfg_t.vocab_size, (2, 7)).astype(np.int32)
    ref = jmodel._token_nll(cfg_j, jnp.asarray(logits), jnp.asarray(labels))
    out = tmodel._token_nll(cfg_t, _t(logits), torch.tensor(labels))
    assert_close(ref, out, 1e-5, "nll")


def test_model_params_from_jax_keeps_bfloat16_exactly():
    """A bf16 tree arrives as ml_dtypes arrays and comes out as torch
    bfloat16 with the same bits."""
    cfg_j = dataclasses.replace(jbase.get_config("rwkv6-3b").reduced(),
                                param_dtype="bfloat16")
    cfg_t = dataclasses.replace(tbase.get_config("rwkv6-3b").reduced(),
                                param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        cfg_j, jax.random.PRNGKey(2)))
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    tp = convert.model_params_from_jax(cfg_t, tree, device="cpu")
    for (path, a), (_, t) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                 jax.tree_util.tree_leaves_with_path(tp)):
        assert t.dtype == torch.bfloat16, path
        assert np.array_equal(a.astype(np.float32), t.float().numpy()), path
    with pytest.raises(ValueError, match="does not fit"):
        convert.model_params_from_jax(tbase.get_config("rwkv6-3b"), tree,
                                      device="cpu")


def test_unported_configs_raise():
    cfg = tbase.get_config("phi4-mini-3.8b").reduced()
    for changes in ({"attention_kind": "mla"}, {"mtp": True},
                    {"rope_kind": "mrope"}, {"encoder_layers": 2}):
        with pytest.raises(NotImplementedError, match="not ported"):
            tmodel.init_params(dataclasses.replace(cfg, **changes),
                               device="cpu")
