"""DeepSeek-V3 Multi-head Latent Attention (MLA).  [arXiv:2412.19437]

Port of ``repro.models.mla``.  Training and prefill run the expanded form:
per-head keys ``[k_nope ; k_rope]`` (the rope key shared by every head)
through the query-chunked ``attention.chunked_gqa_attend``, whose scale
``(dn + dr) ** -0.5`` is the concatenated head's and whose output takes
the value head's width.  Decode runs the absorbed form against a
compressed cache: the latent ``c_kv`` and the shared rope key, ``kv_lora_rank
+ qk_rope_head_dim`` numbers a token and layer (576 for the 671B config)
where an expanded cache holds ``2 H dh`` (32768).

MLA takes no kernel backend, as in the reference: its query/key head (192
wide in the 671B config) is past the flash kernel's 128, and the
reference's ``apply_mla`` always runs the chunked dense attention.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import cache_write, chunked_gqa_attend
from repro_torch.models.layers import apply_rope, dense_init, dtype_of


def init_mla(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """The projections (``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``wo``) and
    the two latent norms' scales; ``lead``: leading stack axes, ``(L,)``
    for a stack of layers."""
    m = cfg.mla
    dt = dtype_of(cfg.param_dtype)
    H = cfg.num_heads
    lead = tuple(lead)
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def ones(n):
        return {"scale": torch.ones(lead + (n,), dtype=dt,
                                    device=gen.device)}

    return {
        "wq_a": dense_init(gen, lead + (cfg.d_model, m.q_lora_rank), dt),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": dense_init(gen, lead + (m.q_lora_rank, H * qk), dt),
        "wkv_a": dense_init(gen, lead + (cfg.d_model, m.kv_lora_rank
                                         + m.qk_rope_head_dim), dt),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": dense_init(gen, lead + (m.kv_lora_rank, H * (
            m.qk_nope_head_dim + m.v_head_dim)), dt),
        "wo": dense_init(gen, lead + (H * m.v_head_dim, cfg.d_model), dt),
    }


def _rms(cfg: ModelConfig, p, x):
    """MLA's own RMSNorm of a latent: float32, eps 1e-6, cast back to
    ``x``'s dtype (not ``apply_norm``, as in the reference)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()).to(x.dtype)


def _project(cfg: ModelConfig, p, x):
    """x (B, S, D) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr), c_kv (B,
    S, c) after its norm, k_rope (B, S, dr) before RoPE."""
    m = cfg.mla
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    x = x.to(cd)
    q = _rms(cfg, p["q_norm"], x @ p["wq_a"].to(cd)) @ p["wq_b"].to(cd)
    q = q.reshape(B, S, cfg.num_heads,
                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    kv = x @ p["wkv_a"].to(cd)
    c_kv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    return q_nope, q_rope, _rms(cfg, p["kv_norm"], c_kv), k_rope


def apply_mla(cfg: ModelConfig, p, x, positions, *,
              return_cache: bool = False):
    """Causal MLA of x (B, S, D) in the expanded form -> out (B, S, D); with
    ``return_cache`` also the decode cache's entries of these positions:
    ``c_kv`` (B, S, c) and the rope key after RoPE (B, S, dr)."""
    m = cfg.mla
    cd = dtype_of(cfg.compute_dtype)
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _project(cfg, p, x)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    kv = (c_kv @ p["wkv_b"].to(cd)).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)              # (B, S, H, dqk)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, m.qk_rope_head_dim)],
                       dim=-1)
    out = chunked_gqa_attend(q_full, k_full, v)               # causal
    out = out.reshape(B, S, -1) @ p["wo"].to(cd)
    if return_cache:
        return out, c_kv, k_rope[:, :, 0, :]
    return out


def init_mla_cache(cfg: ModelConfig, batch: int, seq_len: int, layers: int,
                   dtype, device) -> dict:
    """Zeroed compressed caches: ``c_kv`` (layers, batch, seq_len,
    kv_lora_rank) and ``k_rope`` (layers, batch, seq_len,
    qk_rope_head_dim)."""
    m = cfg.mla
    return {"c_kv": torch.zeros((layers, batch, seq_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((layers, batch, seq_len,
                                   m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def decode_mla(cfg: ModelConfig, p, x, c_cache, r_cache, pos):
    """One-token decode in the absorbed form.  x: (B, 1, D); c_cache (B, S,
    c); r_cache (B, S, dr); pos: 0-d integer tensor on x's device.

    Returns (out (B, 1, D), c_cache, r_cache): the token's latent and rope
    key are written into the caches in place at ``pos``
    (``attention.cache_write``, clamped as the reference's), ``wkv_b``'s
    key half is absorbed into the query, and the token attends to the
    latents at positions ``<= pos``.  The two logit products are summed in
    the compute dtype and only then cast to float32 and scaled, in the
    reference's order."""
    m = cfg.mla
    cd = dtype_of(cfg.compute_dtype)
    B = x.shape[0]
    H = cfg.num_heads
    q_nope, q_rope, c_kv, k_rope = _project(cfg, p, x)      # S == 1
    pvec = pos.reshape(1, 1).expand(B, 1)
    q_rope = apply_rope(q_rope, pvec, cfg.rope_theta)
    k_rope = apply_rope(k_rope[:, :, None, :], pvec,
                        cfg.rope_theta)[:, :, 0, :]
    cache_write(c_cache, c_kv, pos)
    cache_write(r_cache, k_rope, pos)
    wkv_b = p["wkv_b"].to(cd).reshape(m.kv_lora_rank, H,
                                      m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    q_lat = torch.einsum("bshd,chd->bshc", q_nope, w_uk)
    c_all, r_all = c_cache.to(cd), r_cache.to(cd)
    logits = (torch.einsum("bshc,btc->bhst", q_lat, c_all)
              + torch.einsum("bshd,btd->bhst", q_rope, r_all))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    logits = logits.float() * scale
    mask = torch.arange(c_cache.shape[1], device=x.device) <= pos
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out_lat = torch.einsum("bhst,btc->bshc", w.to(cd), c_all)
    out = torch.einsum("bshc,chd->bshd", out_lat, w_uv).reshape(B, 1, -1)
    return out @ p["wo"].to(cd), c_cache, r_cache
