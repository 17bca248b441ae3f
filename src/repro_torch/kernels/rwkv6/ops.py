"""Chunked WKV6 recurrence (RWKV-6 linear attention).

Port of ``repro.kernels.rwkv6`` (``kernel.wkv6_bhsn`` and the ``ops.wkv6``
wrapper).  :func:`wkv6` takes the models' layout, ``r, k, v, w (B, S, H,
N)``, ``u (H, N)``, ``state (B, H, N, N)``, and casts ``w`` and ``u`` to
``r``'s dtype as the reference wrapper does (in bfloat16 that rounds the
decay).  On CUDA tensors it is one launch of the hand-written kernel
``csrc/wkv6.cu``; on CPU tensors the plain twin :func:`wkv6_plain`, the
sequential :func:`wkv6_scan` (the reference's ``ref.wkv6_ref``).  The
output has ``r``'s dtype, the final state is float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import SMEM_PER_BLOCK

CHUNK = 32


def pick_chunk(S: int, chunk: int = CHUNK) -> int:
    """The reference's chunk: ``min(chunk, S)``, decremented until it
    divides ``S``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def smem_bytes(N: int, C: int) -> int:
    """Shared-memory bytes of one block: the state, six (C, N + 1) chunk
    arrays, the (C, C) matrix and three small vectors."""
    return 4 * (N * N + 6 * C * (N + 1) + C * C + C + 2 * N)


def wkv6_scan(r, k, v, w, u, state):
    """The sequential recurrence in float32, the one plain WKV6 of the port
    (the models' ``"reference"`` backend below 128 tokens calls it too).
    r, k, v, w (B, S, H, N); u (H, N) or (B, H, N); state (B, H, N, N).
    Returns (out (B, S, H, N) float32, final state float32)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()[..., None]
    S_ = state.float()
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        outs.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], S_ + uf * kv))
        S_ = wf[:, t, :, :, None] * S_ + kv
    return torch.stack(outs, dim=1), S_


def wkv6_ref(r, k, v, w, u, s0):
    """The reference's ``wkv6_ref`` layout: r, k, v, w (BH, S, N); u (BH,
    1, N); s0 (BH, N, N), each row one head of :func:`wkv6_scan`.  Returns
    (out in r's dtype, final state float32)."""
    out, s_fin = wkv6_scan(*(a[:, :, None] for a in (r, k, v, w)), u,
                           s0[:, None])
    return out[:, :, 0].to(r.dtype), s_fin[:, 0]


def wkv6_plain(r, k, v, w, u, state):
    """The kernel's plain twin in the models' layout: :func:`wkv6_scan`
    after the reference wrapper's casts of ``w`` and ``u`` to r's dtype."""
    out, s_fin = wkv6_scan(r, k, v, w.to(r.dtype), u.to(r.dtype), state)
    return out.to(r.dtype), s_fin


def _load():
    from repro_torch.kernels import build
    lib = build.load("wkv6")
    if lib.wkv6_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wkv6_launch.argtypes = [p] * 8 + [i] * 7 + [p]
        lib.wkv6_launch.restype = ctypes.c_int
    return lib


def wkv6_cuda(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """One launch of ``csrc/wkv6.cu``: grid (B * H), the chunk loop inside."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {dev}; CPU "
                         f"tensors take the plain twin")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wkv6_cuda takes float32 or bfloat16, got "
                         f"{r.dtype}")
    B, S, H, N = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, N)),
                           ("state", state, (B, H, N, N))):
        if tuple(t.shape) != tuple(shape) or t.device != dev:
            raise ValueError(f"{name}: expected {tuple(shape)} on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise ValueError(f"{name}: expected {r.dtype}, got {t.dtype}")
    C = pick_chunk(S, chunk)
    smem = smem_bytes(N, C)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head size {N} needs {smem} bytes of shared memory, "
                         f"over the {SMEM_PER_BLOCK}-byte limit of one block")
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w = w.to(r.dtype).contiguous()
    u = u.to(r.dtype).contiguous()
    s0 = state.float().contiguous()
    out = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_fin.data_ptr(),
            int(r.dtype == torch.bfloat16), B, S, H, N, C, smem, stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "wkv6")
    wkv6_cuda.launches += 1
    return out, s_fin


wkv6_cuda.launches = 0


def wkv6(r, k, v, w, u, state, *, chunk: int = CHUNK):
    """r, k, v, w (B, S, H, N); u (H, N); state (B, H, N, N) -> (out (B, S,
    H, N) in r's dtype, new state (B, H, N, N) float32): the kernel on CUDA
    tensors, the plain twin on CPU tensors."""
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, state, chunk=chunk)
    return wkv6_plain(r, k, v, w, u, state)
