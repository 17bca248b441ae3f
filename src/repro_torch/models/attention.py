"""GQA attention for training, prefill and cached decode.

Port of ``repro.models.attention`` (``init_attention``, ``_project_qkv``,
``gqa_attend``, ``chunked_gqa_attend``, ``causal_mask``,
``apply_attention``, ``init_kv_cache``, ``cache_write``,
``decode_attention``).  ``backend="pallas"`` runs the causal path through
the hand-written flash-attention kernel (``kernels/flash_attention``), which
on CUDA tensors launches ``csrc/flash_attention.cu`` and never falls back;
``"reference"`` runs the query-chunked dense attention.  ``gqa_attend`` and
``causal_mask`` live beside the kernel, whose plain twin they are, and are
imported here.  RoPE is applied for ``rope_kind`` ``"rope"`` and
``"mrope"`` (Qwen2-VL's sections over (t, h, w) positions), none for
``"none"``.  :func:`apply_cross_attention` is the encoder-decoder's cross
attention: the dense ``gqa_attend``, no mask, no RoPE and no bias, as the
reference's; its K and V (:func:`cross_kv`) are what a decode cache keeps.
A decode step attends one token to the whole KV cache through the dense
``gqa_attend``, as the reference's does.  Under a mesh
(``act_sharding.activation_mesh``) it runs the reference's mesh chain
instead: the cache write is a masked write over every slot (at ``pos >=
S`` it writes nothing, where the mesh-less write overwrites the last
slot), and the attention is a grouped einsum, a float32 masked softmax
and a second einsum, each step constrained to the cache's sequence
sharding (``constrain`` records it; one controller computes every shard).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import (causal_mask,
                                                     flash_attention,
                                                     gqa_attend)
from repro_torch.models import act_sharding
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       to_cache_dtype)
from repro_torch.models.sharding import kv_cache_spec

BACKENDS = ("reference", "pallas")


def resolve_backend(backend: Optional[str] = None) -> str:
    backend = "reference" if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown model backend {backend!r}; choose from "
                         f"{BACKENDS}")
    return backend


def init_attention(cfg: ModelConfig, gen: torch.Generator, lead=()):
    dt = dtype_of(cfg.param_dtype)
    dh = cfg.resolved_head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (cfg.d_model, cfg.num_heads * dh), dt),
        "wk": dense_init(gen, lead + (cfg.d_model, cfg.num_kv_heads * dh), dt),
        "wv": dense_init(gen, lead + (cfg.d_model, cfg.num_kv_heads * dh), dt),
        "wo": dense_init(gen, lead + (cfg.num_heads * dh, cfg.d_model), dt),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                            ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros(lead + (width * dh,), dtype=dt,
                                  device=gen.device)
    return p


def _project_qkv(cfg: ModelConfig, p, x):
    cd = dtype_of(cfg.compute_dtype)
    dh = cfg.resolved_head_dim
    B, S, _ = x.shape
    x = x.to(cd)
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    return (q.reshape(B, S, cfg.num_heads, dh),
            k.reshape(B, S, cfg.num_kv_heads, dh),
            v.reshape(B, S, cfg.num_kv_heads, dh))


def chunked_gqa_attend(q, k, v, *, sliding_window: int = 0,
                       chunk: int = 1024):
    """Causal attention a chunk of queries at a time, so the scores stay at
    (B, H, chunk, S); every chunk masks the whole key range, as the
    reference does."""
    B, S, H, dh = q.shape
    if S <= chunk:
        return gqa_attend(q, k, v, causal_mask(S, S, sliding_window,
                                               q.device))
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for c0 in range(0, S, chunk):
        qi = q[:, c0:c0 + chunk]
        qpos = c0 + torch.arange(qi.shape[1], device=q.device)[:, None]
        m = kpos <= qpos
        if sliding_window:
            m = m & (kpos > qpos - sliding_window)
        outs.append(gqa_attend(qi, k, v, m[None]))
    return torch.cat(outs, dim=1)


def apply_attention(cfg: ModelConfig, p, x, positions, *,
                    causal: bool = True, backend: Optional[str] = None,
                    chunk: int = 1024, return_kv: bool = False):
    """Self-attention of x (B, S, D).  ``backend="pallas"`` sends the causal
    path through the flash kernel.  With ``return_kv`` also returns the
    post-RoPE K and V."""
    backend = resolve_backend(backend)
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q, k = _rotate(cfg, q, k, positions)
    if backend == "pallas" and causal:
        out = flash_attention(q, k, v, causal=True,
                              sliding_window=cfg.sliding_window)
    elif causal:
        out = chunked_gqa_attend(q, k, v, sliding_window=cfg.sliding_window,
                                 chunk=chunk)
    else:
        out = gqa_attend(q, k, v, None)
    cd = dtype_of(cfg.compute_dtype)
    out = out.reshape(B, S, -1) @ p["wo"].to(cd)
    if return_kv:
        return out, k, v
    return out


def _rotate(cfg: ModelConfig, q, k, positions):
    """q and k after RoPE or M-RoPE (as ``rope_kind`` says), or as they
    are for ``"none"``."""
    if cfg.rope_kind in ("rope", "mrope"):
        return (apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    if cfg.rope_kind != "none":
        raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} is not "
                                  f"ported")
    return q, k


def cross_kv(cfg: ModelConfig, p, kv_src):
    """Cross attention's K and V from the encoder's output kv_src (B, T,
    D): (B, T, Hkv, dh) each in the compute dtype, no bias."""
    cd = dtype_of(cfg.compute_dtype)
    B, T, _ = kv_src.shape
    shape = (B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
    src = kv_src.to(cd)
    return ((src @ p["wk"].to(cd)).reshape(shape),
            (src @ p["wv"].to(cd)).reshape(shape))


def cross_attend(cfg: ModelConfig, p, x, k, v):
    """Cross attention of the decoder's normed x (B, S, D) to K and V (B,
    T, Hkv, dh): unmasked dense attention, the output projection; the
    queries carry no bias and no RoPE."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    q = (x.to(cd) @ p["wq"].to(cd)).reshape(B, S, cfg.num_heads,
                                           cfg.resolved_head_dim)
    out = gqa_attend(q, k.to(q.dtype), v.to(q.dtype), None)
    return out.reshape(B, S, -1) @ p["wo"].to(cd)


def apply_cross_attention(cfg: ModelConfig, p, x, kv_src):
    """Encoder-decoder cross attention of x (B, S, D) to the encoder's
    output kv_src (B, T, D): no mask, no RoPE, no bias."""
    return cross_attend(cfg, p, x, *cross_kv(cfg, p, kv_src))


# ---------------------------------------------------------------------------
# decode with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, layers: int,
                  dtype, device) -> dict:
    """Zeroed K and V caches, (layers, batch, seq_len, num_kv_heads, dh)."""
    shape = (layers, batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_write(cache, new, pos):
    """Write one token's K/V ``new`` (B, 1, ...) into ``cache`` (B, S, ...)
    at ``pos`` on axis 1, in place, and return ``cache``.  ``pos`` is a 0-d
    integer tensor on the cache's device (no host synchronisation).  As
    ``jax.lax.dynamic_update_slice`` does, a position past the end is
    clamped: ``pos >= S`` overwrites the last slot.  Under a mesh, the
    reference's masked write: every slot is read and written, the one at
    ``pos`` takes ``new``, and at ``pos >= S`` none does."""
    new = to_cache_dtype(new, cache.dtype)
    if act_sharding.current_mesh() is not None:
        S = cache.shape[1]
        hit = (torch.arange(S, device=cache.device) == pos).reshape(
            (1, S) + (1,) * (cache.dim() - 2))
        if cache.dtype.itemsize == 1:
            # float8 has no where kernel: move its bytes
            bits = cache.view(torch.uint8)
            torch.where(hit, new.view(torch.uint8), bits, out=bits)
        else:
            torch.where(hit, new, cache, out=cache)
        return cache
    idx = pos.clamp(0, cache.shape[1] - 1).reshape(1)
    if cache.dtype.itemsize == 1:
        # float8 has no index_copy kernel: move its bytes
        cache.view(torch.uint8).index_copy_(1, idx, new.view(torch.uint8))
    else:
        cache.index_copy_(1, idx, new)
    return cache


def decode_attention(cfg: ModelConfig, p, x, cache_k, cache_v, pos):
    """One-token decode.  x: (B, 1, D); cache_k / cache_v: (B, S, Hkv, dh);
    pos: 0-d integer tensor on x's device.

    Returns (out (B, 1, D), cache_k, cache_v): the new token's K/V are
    written into the caches in place at ``pos`` (``cache_write``) and the
    token attends to the cache positions ``<= pos`` (and inside the
    sliding window), the whole cache cast up to the compute dtype."""
    B = x.shape[0]
    S = cache_k.shape[1]
    q, k, v = _project_qkv(cfg, p, x)                        # (B, 1, ., dh)
    pvec = pos.reshape(1, 1).expand(B, 1)
    if cfg.rope_kind == "mrope":
        pvec = pvec[..., None].expand(B, 1, 3)
    q, k = _rotate(cfg, q, k, pvec)
    cache_write(cache_k, k, pos)
    cache_write(cache_v, v, pos)
    kpos = torch.arange(S, device=x.device)[None, None, :]   # (1, 1, S)
    mask = kpos <= pos
    if cfg.sliding_window:
        mask = mask & (kpos > pos - cfg.sliding_window)
    mesh = act_sharding.current_mesh()
    if mesh is not None:
        out = _mesh_decode_attend(mesh, q, cache_k, cache_v, mask)
    else:
        out = gqa_attend(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)
    cd = dtype_of(cfg.compute_dtype)
    out = out.reshape(B, 1, -1) @ p["wo"].to(cd)
    return out, cache_k, cache_v


def _mesh_decode_attend(mesh, q, cache_k, cache_v, mask):
    """The reference's decode attention under a mesh: q (B, 1, H, dh)
    against the cache (B, S, Hkv, dh) in the compute dtype, grouped by KV
    head; the logits (B, Hkv, G, 1, S) cast to float32 and scaled, masked
    to -1e30 where ``mask`` (1, 1, S) is False, softmaxed, cast to V's
    dtype and contracted with V -> (B, 1, H dh).  Each step is constrained
    to the cache's sequence sharding."""
    B, S = cache_k.shape[:2]
    spec = kv_cache_spec(mesh, B, S)[1:]                     # (B, S, H, dh)
    seq_ax = spec[1]
    k = act_sharding.constrain(cache_k.to(q.dtype), *spec)
    v = act_sharding.constrain(cache_v.to(q.dtype), *spec)
    Hkv, dh = k.shape[2], q.shape[-1]
    qg = q.reshape(B, 1, Hkv, q.shape[2] // Hkv, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * dh ** -0.5
    logits = act_sharding.constrain(logits, spec[0], None, None, None,
                                    seq_ax)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    w = act_sharding.constrain(w, spec[0], None, None, None, seq_ax)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(B, 1, -1)
