"""RWKV-6 "Finch" time mix and channel mix.

Port of the RWKV-6 part of ``repro.models.ssm``.  Per head, with a key-dim
N x value-dim N state S:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

``backend="pallas"`` runs the recurrence through the hand-written chunked
WKV6 kernel (``kernels/rwkv6``: ``csrc/wkv6.cu`` on CUDA tensors, never a
fallback there); ``"reference"`` runs :func:`wkv6_chunked` from 128 tokens
on, else the sequential ``wkv6_scan``, which is the kernel's own plain twin
(``kernels/rwkv6/ops.py``).  Mamba is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_scan
from repro_torch.models.attention import resolve_backend
from repro_torch.models.layers import dense_init, dtype_of


# ---------------------------------------------------------------------------
# RWKV-6 time mix
# ---------------------------------------------------------------------------

def init_rwkv_tmix(cfg: ModelConfig, gen: torch.Generator, lead=()):
    dt = dtype_of(cfg.param_dtype)
    D, H, N = cfg.d_model, cfg.num_heads, cfg.ssm.head_dim
    if H * N != D:
        raise ValueError(f"rwkv needs num_heads x head_dim == d_model, got "
                         f"{H} x {N} != {D}")
    lead = tuple(lead)
    dev = gen.device
    lora = max(32, D // 16)

    def full(value):
        return torch.full(lead + (D,), value, dtype=dt, device=dev)

    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        "w_in": dense_init(gen, lead + (D, 4 * D), dt),
        "w_decay_a": dense_init(gen, lead + (D, lora), dt),
        "w_decay_b": dense_init(gen, lead + (lora, D), dt, scale=0.1),
        "w0": full(-6.0),
        "u": (torch.randn(lead + (H, N), generator=gen, dtype=torch.float32,
                          device=dev) * 0.1).to(dt),
        "w_out": dense_init(gen, lead + (D, D), dt),
        "ln_x_scale": full(1.0),
    }


def _tshift(x, x_prev):
    """x: (B, S, D) shifted right by one token; x_prev fills position 0."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_project(cfg: ModelConfig, p, x, x_prev):
    """-> r, k, v (B, S, H, N), g (B, S, D), the decay w (B, S, H, N) in
    (0, 1) as float32, and the last token of x for the next shift."""
    cd = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    H, N = cfg.num_heads, cfg.ssm.head_dim
    x = x.to(cd)
    xs = _tshift(x, x_prev.to(cd))

    def mix(mu):
        return x + (xs - x) * mu.to(cd)

    rkvg = mix(p["mu_r"]) @ p["w_in"].to(cd)
    r, k, v, g = rkvg.chunk(4, dim=-1)
    dec = mix(p["mu_w"]) @ p["w_decay_a"].to(cd)
    dec = torch.tanh(dec) @ p["w_decay_b"].to(cd)
    w = torch.exp(-torch.exp(p["w0"].float() + dec.float()))
    shp = (B, S, H, N)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), g,
            w.reshape(shp), x[:, -1, :])


def wkv6_chunked(r, k, v, w, u, state, *, chunk: int = 64):
    """Chunked WKV6 in plain PyTorch, the algebra of the WKV6 kernel:
    within a chunk everything is a matrix product, the state is carried
    from chunk to chunk.  ``w`` is rounded to ``r``'s dtype first, as the
    reference does.  Falls back to :func:`wkv6_scan` unless ``chunk``
    divides S and S > chunk."""
    B, S, H, N = r.shape
    if S % chunk or S <= chunk:
        return wkv6_scan(r, k, v, w, u, state)
    w = w.to(r.dtype)
    uf = u.float()
    ti = torch.arange(chunk, device=r.device)
    tril = (ti[None, :] < ti[:, None]).float()
    S0 = state.float()
    outs = []
    for c0 in range(0, S, chunk):
        # (B, C, H, N) -> (B, H, C, N), float32 per chunk
        rc, kc, vc, wc = (a[:, c0:c0 + chunk].transpose(1, 2).float()
                          for a in (r, k, v, w))
        lw = torch.log(torch.clamp(wc, min=1e-30))
        lp = torch.cumsum(lw, dim=2)
        r_t = rc * torch.exp(lp - lw)               # r * P_{t-1}
        k_t = kc * torch.exp(-lp)                   # k / P_t
        inter = torch.einsum("bhcn,bhnm->bhcm", r_t, S0)
        A = torch.einsum("bhcn,bhsn->bhcs", r_t, k_t) * tril
        intra = torch.einsum("bhcs,bhsm->bhcm", A, vc)
        diag = (rc * uf[None, :, None, :] * kc).sum(-1, keepdim=True)
        outs.append((inter + intra + diag * vc).transpose(1, 2))
        decay = torch.exp(lp[:, :, -1, :])
        kv = torch.einsum("bhsn,bhsm->bhnm", k_t, vc)
        S0 = decay[..., None] * (S0 + kv)
    return torch.cat(outs, dim=1), S0


def apply_rwkv_tmix(cfg: ModelConfig, p, x, x_prev, state, *,
                    backend: Optional[str] = None):
    """x: (B, S, D) -> (out, new x_prev, new state)."""
    backend = resolve_backend(backend)
    cd = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    r, k, v, g, w, x_last = rwkv6_project(cfg, p, x, x_prev)
    if backend == "pallas":
        out, new_state = wkv6(r, k, v, w, p["u"], state)
    elif S >= 128:
        out, new_state = wkv6_chunked(r, k, v, w, p["u"], state)
    else:
        out, new_state = wkv6_scan(r, k, v, w, p["u"], state)
    # per-head group norm
    of = out.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, unbiased=False, keepdim=True)
    of = (of - mu) * torch.rsqrt(var + 1e-5)
    of = of.reshape(B, S, D) * p["ln_x_scale"].float()
    out = of.to(cd) * F.silu(g.to(cd))
    return out @ p["w_out"].to(cd), x_last, new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# RWKV channel mix (token-shifted squared-relu FFN with receptance gate)
# ---------------------------------------------------------------------------

def init_rwkv_cmix(cfg: ModelConfig, gen: torch.Generator, lead=()):
    dt = dtype_of(cfg.param_dtype)
    D, Fd = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "mu_k": torch.full(lead + (D,), 0.5, dtype=dt, device=gen.device),
        "mu_r": torch.full(lead + (D,), 0.5, dtype=dt, device=gen.device),
        "w1": dense_init(gen, lead + (D, Fd), dt),
        "w2": dense_init(gen, lead + (Fd, D), dt),
        "wr": dense_init(gen, lead + (D, D), dt),
    }


def apply_rwkv_cmix(cfg: ModelConfig, p, x, x_prev):
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    xs = _tshift(x, x_prev.to(cd))
    xk = x + (xs - x) * p["mu_k"].to(cd)
    xr = x + (xs - x) * p["mu_r"].to(cd)
    h = torch.relu(xk @ p["w1"].to(cd)).square() @ p["w2"].to(cd)
    return torch.sigmoid(xr @ p["wr"].to(cd)) * h, x[:, -1, :]
