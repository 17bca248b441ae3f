"""Hymba hybrid block: parallel attention + Mamba heads on the same input,
outputs normalized and averaged.  [arXiv:2411.13676]

Port of ``repro.models.hybrid``.  ``backend="pallas"`` sends the attention
branch through the flash kernel (``models/attention.apply_attention``: on
CUDA tensors it launches ``csrc/flash_attention.cu`` or raises, with the
config's sliding window); the Mamba branch is always the plain
``ssm.apply_mamba``, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import dtype_of


def init_hybrid(cfg: ModelConfig, gen: torch.Generator, lead=()):
    dt = dtype_of(cfg.param_dtype)
    lead = tuple(lead)
    # SSM branch sized to the attention branch (d_inner == H * dh)
    d_inner = cfg.num_heads * cfg.resolved_head_dim
    return {
        "attn": attn_mod.init_attention(cfg, gen, lead),
        "mamba": ssm_mod.init_mamba(cfg, gen, lead, d_inner=d_inner),
        "out_norm_attn": torch.ones(lead + (cfg.d_model,), dtype=dt,
                                    device=gen.device),
        "out_norm_ssm": torch.ones(lead + (cfg.d_model,), dtype=dt,
                                   device=gen.device),
    }


def _rms(x, scale):
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


def merge(p, a, m):
    """The two branches' outputs, each normalized, averaged."""
    return 0.5 * (_rms(a, p["out_norm_attn"]) + _rms(m, p["out_norm_ssm"]))


def apply_hybrid(cfg: ModelConfig, p, x, positions, *,
                 backend: Optional[str] = None):
    """Train / prefill: x (B, S, D) -> the block mixer's output (B, S, D)."""
    a = attn_mod.apply_attention(cfg, p["attn"], x, positions,
                                 backend=backend)
    m, _, _ = ssm_mod.apply_mamba(cfg, p["mamba"], x)
    return merge(p, a, m)


def decode_hybrid(cfg: ModelConfig, p, x, cache_k, cache_v, conv_state,
                  ssm_state, pos):
    """One-token decode through both branches -> (out, cache_k, cache_v
    (written in place), the new conv state, the new SSM state)."""
    a, cache_k, cache_v = attn_mod.decode_attention(
        cfg, p["attn"], x, cache_k, cache_v, pos)
    m, conv_state, ssm_state = ssm_mod.apply_mamba(
        cfg, p["mamba"], x, conv_state=conv_state, ssm_state=ssm_state)
    return merge(p, a, m), cache_k, cache_v, conv_state, ssm_state
