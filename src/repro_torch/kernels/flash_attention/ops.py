"""Causal / sliding-window flash attention, GQA-aware.

Port of ``repro.kernels.flash_attention`` (``kernel.flash_attention_bhsd``
and the ``ops.flash_attention`` wrapper).  :func:`flash_attention` takes the
models' layout, ``q (B, S, H, dh)`` and ``k, v (B, S, Hkv, dh)``: on CUDA
tensors one launch of a hand-written kernel of ``csrc/flash_attention.cu``
(query head ``h`` reads KV head ``h // (H // Hkv)`` in place), picked by
dtype: bfloat16 runs on the tensor cores (:func:`flash_attention_bf16_cuda`,
wgmma fed by TMA), float32 on the CUDA cores
(:func:`flash_attention_fp32_cuda`); any other dtype raises.  On CPU tensors
it is the plain twin :func:`flash_attention_plain`, dense :func:`gqa_attend`
under the same mask (the reference's ``ref.attention_ref`` after its
wrapper's KV-head repeat).  :func:`flash_attention_tiled` walks the
reference kernel's key tiles with its online softmax: a test oracle that
rounds p where the kernels round it.

The key tile is the reference's ``min(128, S)`` and must divide ``S``, as
the reference asserts; other lengths raise.  The kernels are built for
head dims 32, 64 and 128; the wrapper serves every dh up to 128 by zero
padding to the next of those (:func:`pad_head_dim`), scaled by the
caller's ``dh ** -0.5``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import SMEM_PER_BLOCK

BLOCK = 128          # the reference's block_q = block_k
FP32_BQ = 64         # query rows per block of the float32 kernel
TC_STAGES = 2        # K/V tiles in flight in the bfloat16 kernel's ring
TC_MIN_SMEM = 120 * 1024   # one bfloat16 block per SM (see the .cu)
KERNEL_DH = (32, 64, 128)
NEG_INF = -1e30


def key_block(S: int) -> int:
    """The reference's key tile ``min(128, S)``; raises unless it divides
    ``S`` (the reference asserts the same)."""
    bk = min(BLOCK, S)
    if S % bk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"{bk}-key block (the reference's min(128, S))")
    return bk


def kernel_head_dim(dh: int) -> int:
    """The head dim the kernels run a head of ``dh`` at: the smallest of
    :data:`KERNEL_DH` that holds it; ``ValueError`` over 128 (at the next
    power of two, 256, the bfloat16 kernel's Q tile and K/V ring would not
    fit shared memory, :func:`smem_bytes`)."""
    for d in KERNEL_DH:
        if d >= dh:
            return d
    raise ValueError(f"flash_attention_cuda serves head dims up to "
                     f"{KERNEL_DH[-1]} (the kernels' head dims {KERNEL_DH}), "
                     f"got {dh}: the next head dim of their tile layout, "
                     f"256, would take {smem_bytes(256, torch.bfloat16)} "
                     f"bytes of the bfloat16 kernel's shared memory, over "
                     f"the {SMEM_PER_BLOCK}-byte limit of one block")


def pad_head_dim(t, d: int):
    """``t`` (..., dh) zero-padded to ``d`` along the head dim.  Padded q
    and k columns add exact zeros to every score, padded v columns give
    zero output columns, which the wrapper slices off; the scores keep the
    caller's scale, ``dh ** -0.5``."""
    dh = t.shape[-1]
    return t if d == dh else torch.nn.functional.pad(t, (0, d - dh))


def smem_bytes(dh: int, dtype: torch.dtype) -> int:
    """Shared-memory bytes of one block of the kernel for ``dtype``.
    bfloat16: 1024 bytes of alignment slack, the 128 query rows and a ring
    of TC_STAGES K and V tiles of 128 rows, bf16, and 8 bytes per barrier
    (Q, then K full, V full and K/V empty per stage), at least
    TC_MIN_SMEM.
    float32: the 64 query rows, a K and a V tile (rows padded by one
    float) and the p tile."""
    if dtype == torch.bfloat16:
        tile = BLOCK * dh * 2
        need = (1024 + tile * (1 + 2 * TC_STAGES)
                + 8 * (1 + 3 * TC_STAGES))
        return max(need, TC_MIN_SMEM)
    return 4 * (FP32_BQ * (dh + 1) + 2 * BLOCK * (dh + 1)
                + FP32_BQ * (BLOCK + 1))


def gqa_attend(q, k, v, mask, *, scale: Optional[float] = None):
    """Dense masked attention, the one plain attention of the port (the
    models' ``"reference"`` backend calls it too).  q: (B, Sq, H, dh); k, v:
    (B, Sk, Hkv, dh); mask broadcastable to (B, Sq, Sk), True == attend, or
    None.  Query head h attends KV head h // (H / Hkv); the grouped einsum
    keeps the repeat virtual.  fp32 softmax over the masked scores (-1e30),
    the weights cast to v's dtype before the value product."""
    B, Sq, H, dh = q.shape
    Hkv = k.shape[2]
    scale = scale if scale is not None else dh ** -0.5
    qg = q.reshape(B, Sq, Hkv, H // Hkv, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, v.shape[-1])


def causal_mask(Sq: int, Sk: int, sliding_window: int = 0, device=None, *,
                causal: bool = True):
    """(1, Sq, Sk) boolean; True == attend.  Query i sits at key position
    i + Sk - Sq; ``causal=False`` keeps only the window."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=device)
    if sliding_window:
        m = m & (kpos > qpos - sliding_window)
    return m[None]


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0,
                          scale: Optional[float] = None):
    """The kernel's plain twin in the models' layout: :func:`gqa_attend`
    under the kernel's mask (``scale`` as there)."""
    S = q.shape[1]
    return gqa_attend(q, k, v, causal_mask(S, S, sliding_window, q.device,
                                           causal=causal), scale=scale)


def attention_ref(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """The reference's ``attention_ref`` layout: q, k, v (BH, S, dh), each
    row one head of :func:`flash_attention_plain`."""
    out = flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                causal=causal, sliding_window=sliding_window)
    return out[:, :, 0]


def flash_attention_tiled(q, k, v, *, causal: bool = True,
                          sliding_window: int = 0,
                          scale: Optional[float] = None):
    """The reference kernel's arithmetic in plain PyTorch, for tests: q
    (B, S, H, dh), k, v (B, S, Hkv, dh), KV heads repeated as the
    reference's wrapper does; 128-key tiles (``min(128, S)``) walked in
    order with the online softmax of ``kernel.py:32-65``: fp32 scores
    ``(q . k) * scale`` (by default ``dh ** -0.5``) masked to -1e30, p
    rounded to v's dtype at the running max before an fp32 product with v,
    out = acc / max(l, 1e-30) in q's dtype."""
    bk = _check(q, k, v)
    B, S, H, dh = q.shape
    rep = H // k.shape[2]
    qh = q.transpose(1, 2).float()
    kh = k.repeat_interleave(rep, dim=2).transpose(1, 2).float()
    vh = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    scale = scale if scale is not None else dh ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, dh), device=q.device)
    for k0 in range(0, S, bk):
        s = qh @ kh[:, :, k0:k0 + bk].transpose(-1, -2) * scale
        kpos = k0 + torch.arange(bk, device=q.device)[None, :]
        mask = torch.ones((S, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos <= qpos)
        if sliding_window:
            mask = mask & (kpos > qpos - sliding_window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float() @ vh[:, :, k0:k0 + bk].float()
        acc = acc * alpha + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.to(q.dtype).transpose(1, 2)


def _load():
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.flash_attention_bf16_launch,
               lib.flash_attention_fp32_launch):
        if fn.argtypes is None:
            fn.argtypes = [p] * 4 + [i] * 8 + [ctypes.c_float, i, p]
            fn.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, S, H, dh) and k, v (B, S, Hkv, dh), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, dh = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over {k.shape[2]} KV "
                         f"heads")
    return key_block(S)


def _check_cuda(q, k, v, dtype):
    """The checks of both kernels: shapes, CUDA tensors of ``dtype``, a
    head dim up to 128; returns the key tile."""
    bk = _check(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    kernel_head_dim(q.shape[3])
    return bk


def _aligned(t):
    """Contiguous and 16-byte aligned, as TMA reads it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry, q, k, v, bk, causal, sliding_window):
    """Launch ``entry`` on q, k, v padded to the kernel's head dim, scaled
    by the caller's; the output sliced back to the caller's dh."""
    from repro_torch.kernels.build import check_launch
    B, S, H, dh = q.shape
    d = kernel_head_dim(dh)
    q, k, v = (_aligned(pad_head_dim(t, d)) for t in (q, k, v))
    out = torch.empty_like(q)
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
            H, k.shape[2], d, bk, int(causal), int(sliding_window),
            dh ** -0.5, smem_bytes(d, q.dtype), stream)
    check_launch(lib, err, entry)
    return out if d == dh else out[..., :dh].contiguous()


def flash_attention_bf16_cuda(q, k, v, *, causal: bool = True,
                              sliding_window: int = 0):
    """One launch of the bfloat16 tensor-core kernel: grid (B * H,
    ceil(S / 128)), a TMA producer and two wgmma consumer warpgroups."""
    bk = _check_cuda(q, k, v, torch.bfloat16)
    out = _launch("flash_attention_bf16_launch", q, k, v, bk, causal,
                  sliding_window)
    flash_attention_bf16_cuda.launches += 1
    return out


flash_attention_bf16_cuda.launches = 0


def flash_attention_fp32_cuda(q, k, v, *, causal: bool = True,
                              sliding_window: int = 0):
    """One launch of the float32 CUDA-core kernel: grid (ceil(S / 64),
    B * H)."""
    bk = _check_cuda(q, k, v, torch.float32)
    out = _launch("flash_attention_fp32_launch", q, k, v, bk, causal,
                  sliding_window)
    flash_attention_fp32_cuda.launches += 1
    return out


flash_attention_fp32_cuda.launches = 0


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0):
    """The kernel for q's dtype: bfloat16 on the tensor cores, float32 on
    the CUDA cores; any other dtype raises and launches nothing."""
    kernels = {torch.bfloat16: flash_attention_bf16_cuda,
               torch.float32: flash_attention_fp32_cuda}
    if q.dtype not in kernels:
        _check(q, k, v)
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, "
                         f"got {q.dtype}")
    return kernels[q.dtype](q, k, v, causal=causal,
                            sliding_window=sliding_window)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """q (B, S, H, dh); k, v (B, S, Hkv, dh) -> (B, S, H, dh): a kernel on
    CUDA tensors, the plain twin on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal,
                                    sliding_window=sliding_window)
    _check(q, k, v)
    return flash_attention_plain(q, k, v, causal=causal,
                                 sliding_window=sliding_window)
