"""float16, and the widest heads, of the two language-model kernels, on the
CPU.

The reference's Pallas kernels take float16 inputs (flash attention rounds
p to v's dtype, WKV6 casts its inputs to float32 and rounds its output)
and any head size; the port's wrappers serve them on the card through the
float16 instantiations, the column-split flash kernels past a head dim of
256 and WKV6 on several clusters past a head of 1024.  Here the port's CPU
paths (the plain twins, the tile-exact oracle) and plain-PyTorch models of
the new partitions are held against the reference's kernels in interpret
mode, and the reduced phi4-mini and rwkv6-3b in float16 through
``lm_loss(backend="pallas")`` against the reference's.  The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.kernels.flash_attention import ops as jflash
from repro.kernels.rwkv6 import ops as jwkv
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch import kernels as tkernels
from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rwkv6 import ops as twkv
from repro_torch.models import model as tmodel
from tests._torch_parity import max_diff, to_np


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _decay(shape, seed):
    """Decays as the RWKV-6 layer makes them: exp(-exp(w0 + d)), w0 = -6,
    d ~ N(0, 0.5)."""
    d = np.random.default_rng(seed).standard_normal(shape)
    return np.exp(-np.exp(-6.0 + 0.5 * d)).astype(np.float32)


def _row_err(ref, out):
    """The largest max |out - ref| of a row over max |ref| of that row."""
    ref, out = to_np(ref).astype(np.float32), to_np(out).astype(np.float32)
    d = np.abs(out - ref).max(-1)
    return float((d / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


# ---------------------------------------------------------------------------
# float16 flash attention
# ---------------------------------------------------------------------------

# (B, S, H, Hkv, dh, window): GQA 2 to 1 at dh 64, a window across the
# 128-key tile at dh 128, one 64-key tile at dh 32 (batch 2)
F16_FLASH_CASES = [(1, 256, 4, 2, 64, 0), (1, 256, 4, 4, 128, 100),
                   (2, 64, 2, 1, 32, 0)]


@pytest.mark.parametrize("case", F16_FLASH_CASES)
def test_flash_float16_matches_reference_kernel(case):
    """float16 q, k, v through the port's flash_attention on the CPU (the
    plain twin) and the tile-exact oracle, against the reference's wrapper
    (Pallas, interpret mode), which returns float16 and rounds p to float16
    at the running max.  The oracle rounds p where the reference does: the
    two float32 results differ by the order of the sums, so a float16
    output differs by one rounding step, one ulp of its row's largest |o|
    (2^-10 of it), and by at most one more where a p lands on the other
    side of a float16 boundary: 2^-9 of the row's largest |o| (the CPU
    reads 7.6e-4 at the first case).  The twin rounds p after normalising
    and its scores to float16: 4e-3 on O(1) outputs (1.95e-3 read)."""
    B, S, H, Hkv, dh, window = case
    q, k, v = (_rand((B, S, h, dh), dh + i).astype(np.float16)
               for i, h in enumerate((H, Hkv, Hkv)))
    ref = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 sliding_window=window)
    assert ref.dtype == jnp.float16
    tq, tk, tv = map(torch.tensor, (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=True,
                                 sliding_window=window)
    assert out.dtype == torch.float16 and out.shape == tq.shape
    assert max_diff(ref, out)[0] <= 4e-3
    tiled = tflash.flash_attention_tiled(tq, tk, tv, causal=True,
                                         sliding_window=window)
    assert tiled.dtype == torch.float16
    assert _row_err(ref, tiled) <= 2 ** -9


def test_flash_tiled_rounds_p_to_float16():
    """The oracle rounds p to v's dtype before the product: with float16
    inputs its output equals a float32 walk of the same tiles whose p is
    rounded to float16, bit for bit, and differs from one that keeps p in
    float32 (the reference's p.astype(v.dtype), kernel.py:57)."""
    B, S, H, dh = 1, 256, 2, 64
    q, k, v = (torch.tensor(_rand((B, S, H, dh), 30 + i)).half()
               for i in range(3))
    out = tflash.flash_attention_tiled(q, k, v)
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    keep = {}
    for rounded in (True, False):
        m = torch.full((B, H, S, 1), -1e30)
        l = torch.zeros((B, H, S, 1))
        acc = torch.zeros((B, H, S, dh))
        pos = torch.arange(S)
        for k0 in range(0, S, 128):
            s = qh @ kh[:, :, k0:k0 + 128].transpose(-1, -2) * dh ** -0.5
            s = torch.where(pos[k0:k0 + 128][None] <= pos[:, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            pp = p.half().float() if rounded else p
            acc = acc * alpha + pp @ vh[:, :, k0:k0 + 128]
            m = m_new
        keep[rounded] = (acc / l.clamp_min(1e-30)).half().transpose(1, 2)
    assert torch.equal(out, keep[True])
    assert not torch.equal(out, keep[False])


# ---------------------------------------------------------------------------
# flash attention past a head dim of 256: the column-split kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dh", [320, 512])
def test_flash_wide_head_dims_match_reference_kernel(dh, window):
    """Head dims 320 and 512 (the column-split kernels' sizes), S 256, GQA
    4 over 2, causal and under a 100-key window: the reference's wrapper
    (Pallas, interpret mode) against the plain twin (online against naive
    softmax: 1e-5 on O(1) outputs) and the tile-exact oracle (the same
    128-key tiles; float32 scores summed over dh products in another order,
    so 1e-6 of a row's largest |o| per 128 of dh, as at dh 256's 2e-6: the
    CPU reads 3.1e-6 at dh 512)."""
    B, S, H, Hkv = 1, 256, 4, 2
    q, k, v = (_rand((B, S, h, dh), dh + window + i)
               for i, h in enumerate((H, Hkv, Hkv)))
    ref = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 sliding_window=window)
    assert tflash.kernel_head_dim(dh) == dh
    tq, tk, tv = map(torch.tensor, (q, k, v))
    kw = dict(causal=True, sliding_window=window)
    out = tflash.flash_attention(tq, tk, tv, **kw)
    assert max_diff(ref, out)[0] <= 1e-5
    assert _row_err(ref, tflash.flash_attention_tiled(tq, tk, tv, **kw)) \
        <= 1e-6 * dh / 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dh", [320, 576])
def test_flash_column_groups_match_the_whole(dh, dtype):
    """The column-split kernels form each group's output columns from the
    same scores and the same rounded p: a column of the output reads its
    own column of V only.  So the tile-exact oracle run with V's columns
    outside one group zeroed, for each group (256 columns on the tensor
    cores, 128 on the CUDA cores; the last group short), and joined equals
    it run whole, bit for bit."""
    B, S, H, Hkv = 1, 256, 2, 1
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(_rand((B, S, h, dh), dh + i)).to(dt)
               for i, h in enumerate((H, Hkv, Hkv)))
    whole = tflash.flash_attention_tiled(q, k, v)
    group = tflash.WIDE_GROUP["fp32" if dtype == "float32" else "tc"]
    n_groups = tflash.column_groups(dh, dt)
    assert n_groups == -(-dh // group) > 1
    cols = torch.arange(dh)
    joined = torch.empty_like(whole)
    for g in range(n_groups):
        own = (cols >= g * group) & (cols < (g + 1) * group)
        joined[..., own] = tflash.flash_attention_tiled(q, k, v * own)[..., own]
    assert torch.equal(whole, joined)


def test_flash_head_of_300_padded_to_320_matches_reference_kernel():
    """A head dim of 300, past 256 and not a multiple of 64: zero-padded to
    320, scaled by the caller's 300 ** -0.5, through the plain twin and
    sliced back, within 1e-5 of the reference's Pallas kernel."""
    B, S, H, Hkv, dh = 1, 128, 2, 1, 300
    q, k, v = (_rand((B, S, h, dh), 300 + i)
               for i, h in enumerate((H, Hkv, Hkv)))
    ref = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True)
    d = tflash.kernel_head_dim(dh)
    assert d == 320
    qp, kp, vp = (tflash.pad_head_dim(torch.tensor(a), d) for a in (q, k, v))
    out = tflash.flash_attention_plain(qp, kp, vp, scale=dh ** -0.5)
    assert not out[..., dh:].any()
    assert max_diff(ref, out[..., :dh])[0] <= 1e-5


# ---------------------------------------------------------------------------
# float16 WKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, N, seed, dtype=np.float32):
    """r, k, v in ``dtype``; w (the layer's decays), u and the state in
    float32, which the wrappers cast (w, u to r's dtype)."""
    r, k, v = (_rand((B, S, H, N), seed + i).astype(dtype) for i in range(3))
    return (r, k, v, _decay((B, S, H, N), seed + 3),
            _rand((H, N), seed + 4, 0.1), _rand((B, H, N, N), seed + 5, 0.1))


@pytest.mark.parametrize("N", [64, 40, 256])
def test_wkv6_float16_matches_reference_kernel(N):
    """float16 r, k, v (and w, u cast to float16 by both wrappers: the
    decay rounds to float16's 11 bits, not bf16's 8) through the port's
    wkv6 on the CPU (the sequential twin) against the reference's wrapper
    (its chunked Pallas kernel in interpret mode): the float16 outputs
    differ by at most one rounding step, 2^-10 of the largest |out| (the
    CPU reads 1.2e-4 of it at N 64); the float32 states by the two
    algebras' summation orders, 1e-5 of the largest |S|.  Heads of 64, of
    40 (padded to 48 on the card) and of 256 (the cluster passes)."""
    B, S, H = 1, 64, 2
    inputs = _wkv_inputs(B, S, H, N, N, np.float16)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=32)
    assert ref.dtype == jnp.float16 and s_ref.dtype == jnp.float32
    out, s_out = twkv.wkv6(*map(torch.tensor, inputs))
    assert out.dtype == torch.float16 and s_out.dtype == torch.float32
    scale = float(np.abs(to_np(ref).astype(np.float32)).max())
    assert max_diff(ref, out)[0] <= 2 ** -10 * scale
    assert max_diff(s_ref, s_out)[0] <= \
        1e-5 * float(np.abs(to_np(s_ref)).max())


def test_wkv6_float16_rounds_the_decay_like_the_reference():
    """w cast to float16 is not w cast to bfloat16: fed the float32 decays,
    the port's float16 call equals its float32 call on the decays rounded
    to float16 (and u), output rounded, bit for bit, and differs from the
    one on decays rounded to bf16."""
    B, S, H, N = 1, 32, 1, 32
    r, k, v, w, u, s0 = map(torch.tensor, _wkv_inputs(B, S, H, N, 9))
    half = twkv.wkv6(r.half(), k.half(), v.half(), w, u, s0)
    same = twkv.wkv6(r.half().float(), k.half().float(), v.half().float(),
                     w.half().float(), u.half().float(), s0)
    other = twkv.wkv6(r.half().float(), k.half().float(), v.half().float(),
                      w.bfloat16().float(), u.half().float(), s0)
    assert torch.equal(half[0], same[0].half())
    assert torch.equal(half[1], same[1])
    assert not torch.equal(half[1], other[1])


# ---------------------------------------------------------------------------
# WKV6 past a head of 1024: several clusters a problem
# ---------------------------------------------------------------------------

def wkv6_multi_cluster_split(r, k, v, w, u, s0, *, chunk, rows=64,
                             max_cluster=16):
    """The cluster passes' partition past a head of 1024, in the reference
    kernel's (BH, S, N) layout, float32: the head's ceil(N / rows) row
    blocks over NC clusters of G blocks (ops.head_split).  Per chunk each
    cluster adds its blocks' parts of A = strict_tril(r~ k~^T) (masked
    before the parts meet) and of sum(r u k) in block order, and forms its
    part of the chunk's own output y_cl = A_cl v + sum_cl(r u k) v; in the
    state pass its part of out is its blocks' parts of r~ S added in block
    order, then y_cl; out adds the NC parts in cluster order.  Each block
    updates its own rows of S."""
    BH, S, N = r.shape
    r, k, v, w, u = (torch.as_tensor(a).float() for a in (r, k, v, w, u))
    n_blocks = -(-N // rows)
    nc = -(-n_blocks // max_cluster)
    g = -(-n_blocks // nc)
    clusters = [[slice(b * rows, min(N, (b + 1) * rows))
                 for b in range(c * g, (c + 1) * g) if b * rows < N]
                for c in range(nc)]
    out = torch.zeros(BH, S, N)
    st = torch.as_tensor(s0).float().clone()
    strict = torch.ones(chunk, chunk).tril(-1)
    for c0 in range(0, S, chunk):
        t = slice(c0, c0 + chunk)
        rc, kc, vc = r[:, t], k[:, t], v[:, t]
        lw = torch.log(torch.clamp(w[:, t], min=1e-30))
        lp = torch.cumsum(lw, dim=1)
        rt = rc * torch.exp(lp - lw)
        kt = kc * torch.exp(-lp)
        total = 0.0
        for blocks in clusters:
            a = dg = part = 0.0
            for b in blocks:
                a = a + rt[..., b] @ kt[..., b].transpose(1, 2) * strict
                dg = dg + (rc[..., b] * u[..., b] * kc[..., b]).sum(
                    -1, keepdim=True)
            for b in blocks:
                part = part + rt[..., b] @ st[:, b]
            total = total + (part + (a @ vc + dg * vc))
        out[:, t] = total
        st = torch.exp(lp[:, -1])[:, :, None] * (
            st + kt.transpose(1, 2) @ vc)
    return out, st


@pytest.mark.parametrize("N", [1088, 1280])
def test_wkv6_heads_past_1024_match_reference_kernel(N):
    """Heads of 1088 (2 clusters of 9 blocks, the last block empty) and
    1280 (2 of 10), S 64 in chunks of 32: the several-cluster partition
    and the sequential twin against the reference's wrapper (its chunked
    Pallas kernel in interpret mode), the same recurrence in other
    summation orders, 1e-5 relative to the largest |out| and |S|."""
    B, S, H = 1, 64, 1
    inputs = _wkv_inputs(B, S, H, N, N)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=32)
    scale = float(np.abs(to_np(ref)).max())
    s_scale = float(np.abs(to_np(s_ref)).max())
    n = twkv.kernel_head_size(N)
    assert n == N and twkv.head_split(n) == {1088: (2, 9),
                                             1280: (2, 10)}[N]
    out, s_out = twkv.wkv6(*map(torch.tensor, inputs))
    assert max_diff(ref, out)[0] <= 1e-5 * scale
    assert max_diff(s_ref, s_out)[0] <= 1e-5 * s_scale
    r, k, v, w, u, s0 = inputs
    ub = np.ascontiguousarray(np.broadcast_to(u[None], (B, H, N))
                              ).reshape(B * H, 1, N)
    part, s_part = wkv6_multi_cluster_split(
        *(x.transpose(0, 2, 1, 3).reshape(B * H, S, N) for x in (r, k, v, w)),
        ub, s0.reshape(B * H, N, N), chunk=32)
    assert max_diff(to_np(ref)[0].transpose(1, 0, 2)[0], part[0])[0] <= \
        1e-5 * scale
    assert max_diff(s_ref, s_part.reshape(B, H, N, N))[0] <= 1e-5 * s_scale


def test_wkv6_head_of_1100_padded_to_1152_matches_reference_kernel():
    """A head of 1100: padded to 1152 (a multiple of 64; 2 clusters of 9
    blocks), zeros in r, k, v, u and the state and ones in w, through the
    sequential twin and sliced back, within 1e-5 of the reference."""
    B, S, H, N = 1, 32, 1, 1100
    inputs = _wkv_inputs(B, S, H, N, 11)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=32)
    n = twkv.kernel_head_size(N)
    assert n == 1152 and twkv.head_split(n) == (2, 9)
    out, s_out = twkv.unpad_heads(*twkv.wkv6_plain(
        *twkv.pad_heads(*map(torch.tensor, inputs), n)), N)
    assert max_diff(ref, out)[0] <= 1e-5 * float(np.abs(to_np(ref)).max())
    assert max_diff(s_ref, s_out)[0] <= \
        1e-5 * float(np.abs(to_np(s_ref)).max())


@pytest.mark.parametrize("N,nc,g,launches", [(1024, 1, 16, 2),
                                             (1088, 2, 9, 3),
                                             (1280, 2, 10, 3),
                                             (2560, 3, 14, 3)])
def test_wkv6_split_and_scratch_past_1024(N, nc, g, launches):
    """Past 1024 a problem's blocks go to ceil(blocks / 16) clusters of
    equal size; the scratch holds each cluster's part of y beside the rows
    of k~^T v, and the state pass's parts of the output one per cluster.
    At one head of 2560, S 4096 (3 x 14 blocks, 2688 rows) the scratch is
    3.70 GB and the whole call 3.87 GB in bf16."""
    assert twkv.head_split(N) == (nc, g)
    assert twkv.launches_per_call(N) == launches
    assert twkv.grid_blocks(1, 1, N) == (N // 16) * nc * g
    rows = nc * g * 64
    per_chunk = nc * g * 32 * 68 + (nc * 32 + rows) * N + rows
    assert twkv.scratch_floats(1, 64, 1, N, 32) == 2 * per_chunk
    assert twkv.parts_floats(1, 64, 1, N) == (0 if nc == 1 else nc * 64 * N)
    if N == 2560:
        assert twkv.scratch_floats(1, 4096, 1, N, 32) * 4 == 3_697_213_440
        assert twkv.call_bytes(1, 4096, 1, N, 32, 2) == 3_870_255_360


def test_wrappers_refuse_calls_the_card_cannot_hold(monkeypatch):
    """An allocation the card cannot make inside a wrapper's allocating
    block (before any launch) becomes a ValueError with the call's byte
    count beside the card's free bytes: here one head of 2560 over 4096
    tokens (3.87 GB) on a card with 1 GB free (torch.cuda's query
    monkeypatched); other errors pass through."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (10 ** 9, 80 * 10 ** 9))
    need = twkv.call_bytes(1, 4096, 1, 2560, 32, 2)
    with pytest.raises(ValueError, match=f"needs {need} bytes .* 1000000000 "
                                         f"bytes free"):
        with tkernels.allocating("wkv6_cuda", need, "cuda"):
            raise torch.OutOfMemoryError("CUDA out of memory")
    with pytest.raises(RuntimeError, match="another"):
        with tkernels.allocating("wkv6_cuda", need, "cuda"):
            raise RuntimeError("another")


# ---------------------------------------------------------------------------
# the reduced models in float16 through lm_loss(backend="pallas")
# ---------------------------------------------------------------------------

F16 = dict(param_dtype="float16", compute_dtype="float16")


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_lm_loss_float16_matches_reference(name):
    """The reduced config with float16 params and compute, S 128, batch 2:
    the port's lm_loss(backend="pallas") (the kernels' CPU twins) against
    the reference's (its Pallas kernels in interpret mode) on the same
    float16 params.  Both round every product and norm to float16 (2^-11
    relative) but at other points (the twin rounds flash's p after
    normalising, the reference at the running max; XLA and PyTorch fuse
    differently): the losses of near-uniform predictions (~ln V) agree to
    2e-3, the logits to 2e-2 of their largest |value|."""
    cfg_j = dataclasses.replace(jbase.get_config(name).reduced(), **F16)
    cfg_t = dataclasses.replace(tbase.get_config(name).reduced(), **F16)
    params = jmodel.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    assert tree["embed"].dtype == np.float16
    tp = convert.model_params_from_jax(cfg_t, tree, device="cpu")
    assert tp["embed"].dtype == torch.float16
    rng = np.random.default_rng(5)
    toks, labels = (rng.integers(0, cfg_j.vocab_size, (2, 128)
                                 ).astype(np.int32) for _ in range(2))
    ref, _ = jmodel.lm_loss(cfg_j, params, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)},
                            backend="pallas")
    out, _ = tmodel.lm_loss(cfg_t, tp, {"tokens": torch.tensor(toks),
                                        "labels": torch.tensor(labels)},
                            backend="pallas")
    assert np.isfinite(float(out))
    assert abs(float(ref) - float(out)) <= 2e-3
    lj, _ = jmodel.forward_train(cfg_j, params, jnp.asarray(toks),
                                 backend="pallas")
    lt, _ = tmodel.forward_train(cfg_t, tp, torch.tensor(toks),
                                 backend="pallas")
    scale = float(np.abs(to_np(lj).astype(np.float32)).max())
    assert max_diff(lj, lt)[0] <= 2e-2 * scale
