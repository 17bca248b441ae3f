"""The head padding of the WKV6 and flash-attention wrappers, on the CPU.

The CUDA kernels are built for WKV6 head sizes that are multiples of 16
(past 192 on a cluster of blocks, past 1024 on several) and for attention
head dims 32, 64, 128 and 256 and, past 256, every multiple of 64 (the
column-split kernels); their wrappers serve any other head (WKV6: padded
to a multiple of 16 up to 256, of 64 above; flash attention: to the next
of 32, 64, 128, 256, then to a multiple of 64) by zero padding to the next
size the kernel takes and slicing the result back
(``kernels/rwkv6/ops.py`` ``pad_heads``, ``kernels/flash_attention/ops.py``
``pad_head_dim``).  Here those padding functions, run through the plain
twins and through the kernels' own algebra in plain PyTorch, are held
against the reference's Pallas kernels in interpret mode at head sizes the
kernels are not built for, and the plain twins at the wide heads the
reference's kernels take.  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash
from repro.kernels.rwkv6 import ops as jwkv
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.rwkv6 import ops as twkv
from tests._torch_parity import assert_close, max_diff, to_np
from tests.test_torch_partitions import wkv6_column_groups


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _decay(shape, seed):
    """Decays as the RWKV-6 layer makes them: exp(-exp(w0 + d)) with the
    configs' w0 = -6 and a data term d ~ N(0, 0.5)."""
    d = np.random.default_rng(seed).standard_normal(shape)
    return np.exp(-np.exp(-6.0 + 0.5 * d)).astype(np.float32)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, N, seed):
    r, k, v = (_rand((B, S, H, N), seed + i) for i in range(3))
    return (r, k, v, _decay((B, S, H, N), seed + 3),
            _rand((H, N), seed + 4, 0.1), _rand((B, H, N, N), seed + 5, 0.1))


def _bh(x):
    """(B, S, H, N) -> (B * H, S, N), the reference kernel's layout."""
    B, S, H, N = x.shape
    return x.transpose(1, 2).reshape(B * H, S, N)


def _chunked_padded(r, k, v, w, u, s0, *, chunk):
    """The kernel's chunked algebra (column groups of 16, as its state
    pass splits a head) on padded inputs in the models' layout; u (H, n)."""
    B, S, H, n = r.shape
    ub = u[None].expand(B, H, n).reshape(B * H, 1, n)
    out, s_fin = wkv6_column_groups(_bh(r), _bh(k), _bh(v), _bh(w), ub,
                                    s0.reshape(B * H, n, n), chunk=chunk,
                                    mb=twkv.COLUMNS_PER_BLOCK)
    return (out.reshape(B, H, S, n).transpose(1, 2),
            s_fin.reshape(B, H, n, n))


@pytest.mark.parametrize("N", [40, 72])
def test_wkv6_padded_heads_match_reference_kernel(N):
    """Heads of 40 and 72 (not multiples of 16) with a chunk of 64 (over
    the kernel's 32), through the reference's wrapper (chunks of 64,
    Pallas in interpret mode).  The port pads the heads to 48 and 80, zeros
    in r, k, v, u and the state and ones in w, and runs the kernel's chunk,
    the largest of at most 32 that divides S: the chunk is a tiling of the
    same recurrence.  Through the sequential twin and through the kernel's
    chunked algebra in column groups of 16, then sliced back, both agree
    with the reference within its float32 reassociation, 1e-5 relative to
    the largest |out| and |S|."""
    B, S, H, chunk = 1, 128, 2, 64
    inputs = _wkv_inputs(B, S, H, N, N)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=chunk)
    scale = float(np.abs(to_np(ref)).max())
    s_scale = float(np.abs(to_np(s_ref)).max())
    n = twkv.kernel_head_size(N)
    assert n == 16 * -(-N // 16) and n in twkv.HEAD_SIZES
    padded = twkv.pad_heads(*map(torch.tensor, inputs), n)
    assert all(t.shape[-1] == n for t in padded)
    assert torch.equal(padded[3][..., N:], torch.ones(B, S, H, n - N))
    kernel_chunk = twkv.pick_chunk(S, min(chunk, twkv.CHUNK))
    assert kernel_chunk == 32
    for what, (out, s_out) in (
            ("sequential twin", twkv.wkv6_plain(*padded)),
            ("chunked algebra", _chunked_padded(*padded,
                                                chunk=kernel_chunk))):
        out, s_out = twkv.unpad_heads(out, s_out, N)
        assert out.shape == (B, S, H, N) and s_out.shape == (B, H, N, N)
        assert max_diff(ref, out)[0] <= 1e-5 * scale, what
        assert max_diff(s_ref, s_out)[0] <= 1e-5 * s_scale, what


def test_wkv6_decay_padded_with_zero_poisons_the_chunked_algebra():
    """Why w is padded with ones: with zeros, the clamped log-decay of the
    padded channels is log(1e-30) a token, exp(-cumsum) overflows within
    two tokens, and k~ = 0 * inf is NaN in every padded column, which the
    products carry into the real outputs."""
    N, n = 40, 48
    padded = list(twkv.pad_heads(*map(torch.tensor,
                                      _wkv_inputs(1, 64, 2, N, 3)), n))
    padded[3] = torch.nn.functional.pad(padded[3][..., :N], (0, n - N))
    out, _ = _chunked_padded(*padded, chunk=32)
    assert not torch.isfinite(out[..., :N]).all()


def test_wkv6_head_size_limits():
    """Every head size up to 256 runs at the next multiple of 16, past it
    at the next multiple of 64; up to 192 on one state-pass block per 16
    padded columns, past it on a cluster of ceil(n / 64) blocks per 16
    columns, past 1024 (more than the card's 16-block cluster) on several:
    1025 runs at 1088 on 2 clusters of 9 blocks."""
    assert [twkv.kernel_head_size(N) for N in (1, 16, 17, 24, 40, 72, 192)] \
        == [16, 16, 32, 32, 48, 80, 192]
    assert [twkv.kernel_head_size(N) for N in (193, 200, 256, 257, 500,
                                               1024, 1025, 2560)] \
        == [208, 208, 256, 320, 512, 1024, 1088, 2560]
    assert twkv.grid_blocks(1, 2, 24) == 4
    assert twkv.grid_blocks(1, 40, 64) == 160
    assert twkv.grid_blocks(1, 10, 256) == 10 * 16 * 4
    assert twkv.grid_blocks(1, 5, 512) == 5 * 32 * 8
    assert twkv.grid_blocks(1, 1, 1024) == 64 * 16
    assert twkv.head_split(1088) == (2, 9)
    assert twkv.grid_blocks(1, 1, 1025) == 68 * 2 * 9
    out, s = twkv.unpad_heads(torch.ones(1, 4, 2, 32), torch.ones(1, 2, 32, 32),
                              24)
    assert out.shape == (1, 4, 2, 24) and s.shape == (1, 2, 24, 24)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("dh", [48, 96])
def test_flash_padded_head_dim_matches_reference_kernel(dh, window):
    """Head dims 48 and 96 (the kernels take 32, 64, 128), causal and with
    a 40-key window, GQA 4 over 2: the reference's wrapper (Pallas,
    interpret mode) against q, k and v zero-padded to 64 and 128 and scaled
    by the caller's dh ** -0.5, through the plain twin (online against
    naive softmax: 1e-5 on O(1) outputs) and through the kernels' oracle
    flash_attention_tiled (the same key tiles: 2e-6 of a row's largest
    |o|), sliced back to dh.  With the padded dim's scale the result
    differs from the reference by far more."""
    B, S, H, Hkv = 1, 128, 4, 2
    rng = np.random.default_rng(dh + window)
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    ref = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 sliding_window=window)
    d = tflash.kernel_head_dim(dh)
    assert d == {48: 64, 96: 128}[dh]
    qp, kp, vp = (tflash.pad_head_dim(torch.tensor(a), d) for a in (q, k, v))
    assert qp.shape == (B, S, H, d) and not qp[..., dh:].any()
    kw = dict(causal=True, sliding_window=window, scale=dh ** -0.5)
    out = tflash.flash_attention_plain(qp, kp, vp, **kw)
    assert not out[..., dh:].any()
    assert_close(ref, out[..., :dh], 1e-5, "plain twin, padded")
    tiled = tflash.flash_attention_tiled(qp, kp, vp, **kw)[..., :dh]
    d_row = np.abs(to_np(ref) - to_np(tiled)).max(-1)
    assert (d_row <= 2e-6 * np.abs(to_np(ref)).max(-1)).all()
    wrong = tflash.flash_attention_plain(qp, kp, vp, causal=True,
                                         sliding_window=window)[..., :dh]
    assert max_diff(ref, wrong)[0] > 1e-2


def test_flash_head_dim_limits():
    """Every head dim up to 256 runs at the next of 32, 64, 128, 256, past
    it at the next multiple of 64 on the column-split kernels (257 at
    320).  At dh 256 the bfloat16 and float16 kernels keep 64 query rows,
    one K and V tile (a one-stage ring), P, 5 barriers and the row maxima
    (181,800 bytes), the float32 kernel Q, one tile for K then V, and p
    (230,400 bytes); past 256 the tensor-core kernels a ring of 4 Q and K
    sub-tiles, V's 256 columns, P, 10 barriers and the row maxima (181,840
    bytes) whatever the head dim, the float32 kernel Q and K sub-tiles,
    V's 128 columns and p (148,992 bytes)."""
    assert [tflash.kernel_head_dim(d) for d in (1, 32, 33, 48, 64, 96, 128)] \
        == [32, 32, 64, 64, 64, 128, 128]
    assert [tflash.kernel_head_dim(d) for d in (129, 160, 192, 256)] \
        == [256] * 4
    assert [tflash.kernel_head_dim(d) for d in (257, 320, 321, 512, 1000)] \
        == [320, 320, 384, 512, 1024]
    for dt in (torch.bfloat16, torch.float16):
        assert tflash.smem_bytes(256, dt) == 181_800
        assert tflash.smem_bytes(320, dt) == tflash.smem_bytes(1024, dt) \
            == 181_840
    assert tflash.smem_bytes(256, torch.float32) == 230_400
    assert tflash.smem_bytes(512, torch.float32) == 148_992
    assert [tflash.column_groups(d, torch.bfloat16) for d in (256, 320, 512)] \
        == [1, 2, 2]
    assert [tflash.column_groups(d, torch.float32) for d in (256, 320, 512)] \
        == [1, 3, 4]
    t = torch.ones(1, 8, 2, 48)
    assert tflash.pad_head_dim(t, 48) is t
    assert torch.equal(tflash.pad_head_dim(t, 64)[..., :48], t)


# ---------------------------------------------------------------------------
# the wide heads: flash attention at dh 192 / 256, WKV6 at N 208 to 512
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("dh", [192, 256])
def test_flash_wide_heads_match_reference_kernel(dh, window):
    """Head dims 192 (zero-padded to 256) and 256, S 256, GQA 4 over 2,
    causal and with a 100-key window: the reference's wrapper (Pallas,
    interpret mode) against the plain twin on the padded inputs, scaled by
    the caller's dh ** -0.5 (online against naive softmax: 1e-5 on O(1)
    outputs), and against flash_attention_tiled, the kernels' oracle (the
    same 128-key tiles: 2e-6 of a row's largest |o|)."""
    B, S, H, Hkv = 1, 256, 4, 2
    rng = np.random.default_rng(dh + window)
    q, k, v = (rng.standard_normal((B, S, h, dh)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    ref = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                                 sliding_window=window)
    d = tflash.kernel_head_dim(dh)
    assert d == 256
    qp, kp, vp = (tflash.pad_head_dim(torch.tensor(a), d) for a in (q, k, v))
    kw = dict(causal=True, sliding_window=window, scale=dh ** -0.5)
    out = tflash.flash_attention_plain(qp, kp, vp, **kw)
    assert not out[..., dh:].any()
    assert_close(ref, out[..., :dh], 1e-5, f"plain twin, dh {dh}")
    tiled = tflash.flash_attention_tiled(qp, kp, vp, **kw)[..., :dh]
    d_row = np.abs(to_np(ref) - to_np(tiled)).max(-1)
    assert (d_row <= 2e-6 * np.abs(to_np(ref)).max(-1)).all()


@pytest.mark.parametrize("N", [208, 256, 512])
def test_wkv6_wide_heads_match_reference_kernel(N):
    """Heads of 208, 256 and 512 (the kernel's sizes past 192, on a cluster
    of 4, 4 and 8 blocks), S 64, chunks of 32: the sequential twin against
    the reference's wrapper (its chunked Pallas kernel in interpret mode),
    the same recurrence in another summation order, 1e-5 relative to the
    largest |out| and |S|; a head of 200 runs padded to 208 and sliced
    back."""
    B, S, H = 1, 64, 2
    inputs = _wkv_inputs(B, S, H, N, N)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=32)
    scale = float(np.abs(to_np(ref)).max())
    s_scale = float(np.abs(to_np(s_ref)).max())
    assert twkv.kernel_head_size(N) == N
    out, s_out = twkv.wkv6_plain(*map(torch.tensor, inputs))
    assert max_diff(ref, out)[0] <= 1e-5 * scale
    assert max_diff(s_ref, s_out)[0] <= 1e-5 * s_scale


def test_wkv6_head_of_200_padded_to_208_matches_reference_kernel():
    """A head of 200 (not a multiple of 16, past 192): padded to 208, zeros
    in r, k, v, u and the state and ones in w, through the sequential twin
    and sliced back, within 1e-5 of the reference's Pallas kernel."""
    B, S, H, N = 1, 64, 1, 200
    inputs = _wkv_inputs(B, S, H, N, 7)
    ref, s_ref = jwkv.wkv6(*map(jnp.asarray, inputs), chunk=32)
    n = twkv.kernel_head_size(N)
    assert n == 208
    out, s_out = twkv.unpad_heads(*twkv.wkv6_plain(
        *twkv.pad_heads(*map(torch.tensor, inputs), n)), N)
    assert max_diff(ref, out)[0] <= 1e-5 * float(np.abs(to_np(ref)).max())
    assert max_diff(s_ref, s_out)[0] <= \
        1e-5 * float(np.abs(to_np(s_ref)).max())
