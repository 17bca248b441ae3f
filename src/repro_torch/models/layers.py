"""Core layers: dtypes, initialisers, norms, RoPE, MLPs.

Port of ``repro.models.layers`` as far as the ported configs
(``phi4-mini-3.8b``, ``rwkv6-3b``) use it.  Parameters are plain dicts of
tensors; a stacked-layer parameter carries a leading layer axis, which the
initialisers accept (the fan-in is always ``shape[-2]``).  Initialisers draw
from a ``torch.Generator`` with the reference's distributions; the two
frameworks' generators give different numbers from one seed, so parity tests
carry the reference's parameters over with ``convert.model_params_from_jax``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``scale / sqrt(fan_in)``, drawn in float32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (scale / math.sqrt(fan_in))).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, shape, device):
    """``shape``: ``(dim,)``, or ``(L, dim)`` for a stack of layers."""
    dt = dtype_of(cfg.param_dtype)
    p = {"scale": torch.ones(shape, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p, x):
    """RMSNorm or LayerNorm in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + 1e-6) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (plain RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, dh); positions: (B, S).  Rotates the two halves of the
    head dimension in float32, cast back to ``x``'s dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs            # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

MLP_ACTIVATIONS = ("swiglu", "rwkv_ffn")


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_model: int, d_ff: int,
             lead=()):
    """``lead``: leading stack axes, ``(L,)`` for a stack of layers."""
    if cfg.activation not in MLP_ACTIVATIONS:
        raise NotImplementedError(f"activation {cfg.activation!r} is not "
                                  f"ported; have {MLP_ACTIVATIONS}")
    dt = dtype_of(cfg.param_dtype)
    lead = tuple(lead)
    p = {"w1": dense_init(gen, lead + (d_model, d_ff), dt)}
    if cfg.activation == "swiglu":
        p["w3"] = dense_init(gen, lead + (d_model, d_ff), dt)
    p["w2"] = dense_init(gen, lead + (d_ff, d_model), dt)
    return p


def apply_mlp(cfg: ModelConfig, p, x):
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w1"].to(cd)) * (x @ p["w3"].to(cd))
        return h @ p["w2"].to(cd)
    if cfg.activation == "rwkv_ffn":
        h = torch.relu(x @ p["w1"].to(cd)).square()
        return h @ p["w2"].to(cd)
    raise NotImplementedError(f"activation {cfg.activation!r} is not ported; "
                              f"have {MLP_ACTIVATIONS}")
