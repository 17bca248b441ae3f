"""Causal / sliding-window flash attention, GQA-aware.

Port of ``repro.kernels.flash_attention`` (``kernel.flash_attention_bhsd``
and the ``ops.flash_attention`` wrapper).  :func:`flash_attention` takes the
models' layout, ``q (B, S, H, dh)`` and ``k, v (B, S, Hkv, dh)``: on CUDA
tensors one launch of the hand-written kernel ``csrc/flash_attention.cu``
(query head ``h`` reads KV head ``h // (H // Hkv)`` in place), on CPU
tensors the plain twin :func:`flash_attention_plain`, dense
:func:`gqa_attend` under the same mask (the reference's
``ref.attention_ref`` after its wrapper's KV-head repeat).

The key tile is the reference's ``min(128, S)`` and must divide ``S``, as
the reference asserts; other lengths raise.  float32 and bfloat16.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import SMEM_PER_BLOCK

BLOCK = 128          # the reference's block_q = block_k
KERNEL_BQ = 64       # query rows per block of the CUDA kernel
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


def smem_bytes(dh: int) -> int:
    """Shared-memory bytes of one block of the kernel: the 64 query rows, a
    K and a V tile (rows padded by one float) and the p tile."""
    return 4 * (KERNEL_BQ * (dh + 1) + 2 * BLOCK * (dh + 1)
                + KERNEL_BQ * (BLOCK + 1))


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
                          sliding_window: int = 0):
    """The kernel's plain twin in the models' layout: :func:`gqa_attend`
    under the kernel's mask."""
    S = q.shape[1]
    return gqa_attend(q, k, v, causal_mask(S, S, sliding_window, q.device,
                                           causal=causal))


def attention_ref(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """The reference's ``attention_ref`` layout: q, k, v (BH, S, dh), each
    row one head of :func:`flash_attention_plain`."""
    out = flash_attention_plain(q[:, :, None], k[:, :, None], v[:, :, None],
                                causal=causal, sliding_window=sliding_window)
    return out[:, :, 0]


def _load():
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [p] * 4 + [i] * 9 + [ctypes.c_float, i, p])
        lib.flash_attention_launch.restype = ctypes.c_int
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


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         sliding_window: int = 0):
    """One launch of ``csrc/flash_attention.cu``: grid (ceil(S / 64), B * H)."""
    bk = _check(q, k, v)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_cuda takes float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name}: expected {q.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    B, S, H, dh = q.shape
    if dh not in KERNEL_DH:
        raise ValueError(f"flash_attention_cuda is built for head dims "
                         f"{KERNEL_DH}, got {dh}")
    smem = smem_bytes(dh)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head dim {dh} needs {smem} bytes of shared memory, "
                         f"over the {SMEM_PER_BLOCK}-byte limit of one block")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), B, S, H, k.shape[2], dh, bk,
            int(causal), int(sliding_window), dh ** -0.5, smem, stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0):
    """q (B, S, H, dh); k, v (B, S, Hkv, dh) -> (B, S, H, dh): the kernel on
    CUDA tensors, the plain twin on CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal,
                                    sliding_window=sliding_window)
    _check(q, k, v)
    return flash_attention_plain(q, k, v, causal=causal,
                                 sliding_window=sliding_window)
