"""Core layers: dtypes, initialisers, norms, RoPE, MLPs.

Port of ``repro.models.layers``: norms, RoPE and Qwen2-VL's M-RoPE, the
sinusoidal positions of the encoder-decoder, and the SwiGLU, RWKV and gelu
MLPs.  Parameters are plain dicts of
tensors; a stacked-layer parameter carries a leading layer axis, which the
initialisers accept (the fan-in is always ``shape[-2]``).  Initialisers draw
from a ``torch.Generator`` with the reference's distributions; the two
frameworks' generators give different numbers from one seed, so parity tests
carry the reference's parameters over with ``convert.model_params_from_jax``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}

# float8_e4m3fn's largest finite value is 448; a value of magnitude above
# 464 (halfway to the next step, 480) rounds past it
E4M3_OVERFLOW = 464.0


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def to_cache_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to a cache's dtype.  Casting to float8_e4m3fn, a value
    that rounds past 448 and an infinity become NaN (0x7F, 0xFF when
    negative), as the reference's cast (XLA, ml_dtypes) makes them, where
    torch's own cast saturates to +-448; a NaN keeps its sign likewise."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    bits = x.to(dtype).view(torch.uint8)
    over = ~(x.abs() <= E4M3_OVERFLOW)              # NaN included
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(over, nan, bits).view(dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

class ShapesOnly:
    """Stands in for the ``torch.Generator`` of an init on the ``"meta"``
    device: parameters with their shapes and dtypes and no memory, nothing
    drawn."""
    device = torch.device("meta")


def randn(gen, shape) -> torch.Tensor:
    """float32 N(0, 1) draws from ``gen`` on its device (none on meta)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen: torch.Generator, shape, dtype, scale: float = 1.0):
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``scale / sqrt(fan_in)``, drawn in float32."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if t.is_meta:
        return t.to(dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: one float32 buffer at a time (a (64, 27392, 5120)
    # stack is 36 GB in float32)
    return t.mul_(scale / math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    return randn(gen, shape).mul_(0.02).to(dtype)


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
# rotary embeddings (RoPE and Qwen2-VL's M-RoPE), sinusoidal positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float, mrope_sections=()):
    """x: (B, S, H, dh); positions: (B, S), or (B, S, 3) for M-RoPE.
    Rotates the two halves of the head dimension in float32, cast back to
    ``x``'s dtype.  With ``mrope_sections`` and (t, h, w) positions the
    dh / 2 frequency slots split into three sections, each turned by its
    own position component [arXiv:2409.12191]; (B, S, 3) positions without
    sections rotate by their first component."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if mrope_sections and positions.ndim == 3:
        if sum(mrope_sections) != x.shape[-1] // 2:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do "
                             f"not split dh / 2 = {x.shape[-1] // 2}")
        pos = torch.cat([positions[..., i:i + 1].float().expand(
            *positions.shape[:2], s) for i, s in enumerate(mrope_sections)],
            dim=-1)                                          # (B, S, dh/2)
        angles = pos * freqs
    else:
        if positions.ndim == 3:
            positions = positions[..., 0]
        angles = positions.float()[..., None] * freqs        # (B, S, dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_at(pos, dim: int) -> torch.Tensor:
    """Sinusoidal position rows, float32, for positions given as a tensor
    (any shape, on any device: a decode's 0-d position stays on the card)
    -> (..., dim): sin at the even columns, cos at the odd ones.  The
    frequencies are the reference's float32 arithmetic (log 10000 rounded
    to float32 first)."""
    pos = pos.float()
    neg_log = -torch.log(torch.tensor(10000.0, dtype=torch.float32,
                                      device=pos.device))
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=pos.device) * (neg_log / dim))
    ang = pos[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *pos.shape, dim)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """The (seq, dim) table of positions 0..seq-1 the encoder adds:
    computed in numpy float64, then cast to float32, as the reference
    computes it."""
    pos = np.arange(seq)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    pe = np.zeros((seq, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

MLP_ACTIVATIONS = ("swiglu", "rwkv_ffn", "gelu")


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
    if cfg.activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(x @ p["w1"].to(cd), approximate="tanh")
        return h @ p["w2"].to(cd)
    raise NotImplementedError(f"activation {cfg.activation!r} is not ported; "
                              f"have {MLP_ACTIVATIONS}")
