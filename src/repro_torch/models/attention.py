"""GQA attention for training and prefill.

Port of ``repro.models.attention`` (``init_attention``, ``_project_qkv``,
``gqa_attend``, ``chunked_gqa_attend``, ``causal_mask``,
``apply_attention``).  ``backend="pallas"`` runs the causal path through the
hand-written flash-attention kernel (``kernels/flash_attention``), which on
CUDA tensors launches ``csrc/flash_attention.cu`` and never falls back;
``"reference"`` runs the query-chunked dense attention.  ``gqa_attend`` and
``causal_mask`` live beside the kernel, whose plain twin they are, and are
imported here.  Cross attention and the cached decode path are not ported
yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import (causal_mask,
                                                     flash_attention,
                                                     gqa_attend)
from repro_torch.models.layers import apply_rope, dense_init, dtype_of

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
    if cfg.rope_kind == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} is not "
                                  f"ported")
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
