"""RWKV-6 "Finch" time mix and channel mix, and the Mamba selective SSM.

Port of ``repro.models.ssm``.  RWKV-6, per head, with a key-dim N x
value-dim N state S:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (diag(u) k_t^T v_t + S_{t-1})

``backend="pallas"`` runs the recurrence through the hand-written chunked
WKV6 kernel (``kernels/rwkv6``: ``csrc/wkv6.cu`` on CUDA tensors, never a
fallback there); ``"reference"`` runs :func:`wkv6_chunked` from 128 tokens
on, else the sequential ``wkv6_scan``, which is the kernel's own plain twin
(``kernels/rwkv6/ops.py``).

Mamba (Hymba's SSM heads), per channel d and state slot j:

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,    y_t = h_t . C_t + D x_t

No kernel stands behind it in the reference (``lax.scan`` step by step),
so the port's is plain PyTorch, and its launches grow with log2 S, never
with S: :func:`mamba_scan` composes the steps' affine maps ``h -> a h +
b`` by doubling, inside every chunk of 64 at once, then over the chunks'
totals, then carries each chunk's start state in.
:func:`mamba_scan_sequential` is its step-by-step oracle, used by no entry
point.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_scan
from repro_torch.models.attention import resolve_backend
from repro_torch.models.layers import dense_init, dtype_of, randn


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
        "u": (randn(gen, lead + (H, N)) * 0.1).to(dt),
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
    divides S and S > chunk.

    Every chunk's products are taken at once, batched over the chunks;
    only the state's carry, ``S <- decay * (S + k^T v)``, runs chunk by
    chunk (two operations each), so a training step records ~2 operations
    a chunk instead of ~15."""
    B, S, H, N = r.shape
    if S % chunk or S <= chunk:
        return wkv6_scan(r, k, v, w, u, state)
    nc = S // chunk
    w = w.to(r.dtype)
    uf = u.float()
    ti = torch.arange(chunk, device=r.device)
    tril = (ti[None, :] < ti[:, None]).float()
    # (B, S, H, N) -> (B, H, nc, C, N), float32
    rc, kc, vc, wc = (a.float().reshape(B, nc, chunk, H, N)
                      .permute(0, 3, 1, 2, 4) for a in (r, k, v, w))
    lw = torch.log(torch.clamp(wc, min=1e-30))
    lp = torch.cumsum(lw, dim=3)
    r_t = rc * torch.exp(lp - lw)                   # r * P_{t-1}
    k_t = kc * torch.exp(-lp)                       # k / P_t
    A = torch.einsum("bhzcn,bhzsn->bhzcs", r_t, k_t) * tril
    intra = torch.einsum("bhzcs,bhzsm->bhzcm", A, vc)
    diag = (rc * uf[None, :, None, None, :] * kc).sum(-1, keepdim=True)
    decay = torch.exp(lp[:, :, :, -1, :])           # (B, H, nc, N)
    kv = torch.einsum("bhzsn,bhzsm->bhznm", k_t, vc)
    S0 = state.float()
    starts = []
    for z in range(nc):
        starts.append(S0)
        S0 = decay[:, :, z, :, None] * (S0 + kv[:, :, z])
    inter = torch.einsum("bhzcn,bhznm->bhzcm", r_t, torch.stack(starts, 2))
    out = inter + intra + diag * vc                 # (B, H, nc, C, N)
    return out.permute(0, 2, 3, 1, 4).reshape(B, S, H, N), S0


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


# ---------------------------------------------------------------------------
# Mamba selective SSM (Hymba's SSM heads)
# ---------------------------------------------------------------------------

# the reference's scan chunk, and the first level's length here
MAMBA_CHUNK = 64


def init_mamba(cfg: ModelConfig, gen: torch.Generator, lead=(),
               d_inner: int = 0):
    """``d_inner`` defaults to ``expand * d_model``; ``A_log`` (log 1..n
    per channel) and ``Dskip`` (ones) are float32 and drawn from
    nothing."""
    s = cfg.ssm
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    di = d_inner or s.expand * D
    n = s.state_size
    dt_rank = s.dt_rank or -(-D // 16)
    lead = tuple(lead)
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=dev))
    return {
        "w_in": dense_init(gen, lead + (D, 2 * di), dt),     # x and gate z
        "conv_w": (randn(gen, lead + (s.conv_width, di)) * 0.1).to(dt),
        "conv_b": torch.zeros(lead + (di,), dtype=dt, device=dev),
        "w_bcdt": dense_init(gen, lead + (di, 2 * n + dt_rank), dt),
        "w_dt": dense_init(gen, lead + (dt_rank, di), dt),
        "dt_bias": torch.full(lead + (di,), -4.0, dtype=dt, device=dev),
        "A_log": a_log.expand(lead + (di, n)).clone(),
        "Dskip": torch.ones(lead + (di,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, lead + (di, D), dt),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal convolution.  x: (B, S, di); w: (W, di) ->
    (y, the new conv state: the last W - 1 rows of [conv_state; x])."""
    B, S, di = x.shape
    W = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, W - 1, di))
    xp = torch.cat([conv_state, x], dim=1)
    # the taps in the reference's order (its sum starts from an exact 0)
    y = xp[:, :S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y + b, xp[:, -(W - 1):]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) at every x (``F.softplus`` turns
    into the identity past 20)."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba_scan_sequential(dA, dBx, C, h0):
    """The oracle of :func:`mamba_scan`: one step at a time, as the
    reference's ``lax.scan``.  dA, dBx (B, S, di, n) float32; C (B, S, n);
    h0 (B, di, n) -> (y (B, S, di), the state after the last step)."""
    h, ys = h0, []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def _doubling_scan(a, b, dim: int):
    """Inclusive scan of the affine maps ``h -> a h + b`` along ``dim``
    (Hillis-Steele): each of ceil(log2 L) levels composes every element
    with the one ``d`` before it.  -> (the products of the a's up to each
    element, each prefix's composition applied to a zero state)."""
    L = a.shape[dim]
    d = 1
    while d < L:
        a_lo, a_hi = a.narrow(dim, 0, L - d), a.narrow(dim, d, L - d)
        b_lo, b_hi = b.narrow(dim, 0, L - d), b.narrow(dim, d, L - d)
        b = torch.cat([b.narrow(dim, 0, d), torch.addcmul(b_hi, a_hi, b_lo)],
                      dim)
        a = torch.cat([a.narrow(dim, 0, d), a_hi * a_lo], dim)
        d *= 2
    return a, b


def mamba_scan(dA, dBx, C, h0, *, chunk: int = MAMBA_CHUNK):
    """The selective scan ``h_t = dA_t h_{t-1} + dBx_t``, ``y_t = h_t .
    C_t`` in float32, on :func:`mamba_scan_sequential`'s arguments, in
    ceil(log2 chunk) + ceil(log2 (S / chunk)) levels of four launches:

    1. a doubling scan inside every chunk at once, from a zero state;
    2. a doubling scan over the chunks' totals, ``h0`` folded into the
       first;
    3. each chunk's start state carried in by one multiply-add.

    A length that is not a multiple of the chunk is padded with identity
    maps (a = 1, b = 0), which change no state.  One step (decode) is one
    step.  Differentiable by autograd."""
    B, S, di, n = dA.shape
    if S == 1:
        h = dA[:, 0] * h0 + dBx[:, 0]
        return torch.einsum("bdn,bn->bd", h, C[:, 0])[:, None], h
    L = min(chunk, S)
    pad = -S % L
    if pad:
        dA = torch.cat([dA, dA.new_ones((B, pad, di, n))], dim=1)
        dBx = torch.cat([dBx, dBx.new_zeros((B, pad, di, n))], dim=1)
    nc = (S + pad) // L
    a, b = _doubling_scan(dA.reshape(B, nc, L, di, n),
                          dBx.reshape(B, nc, L, di, n), 2)
    a_tot, b_tot = a[:, :, -1], b[:, :, -1]               # (B, nc, di, n)
    b_tot = torch.cat([torch.addcmul(b_tot[:, :1], a_tot[:, :1],
                                     h0[:, None]), b_tot[:, 1:]], dim=1)
    _, ends = _doubling_scan(a_tot, b_tot, 1)             # each chunk's end
    starts = torch.cat([h0[:, None], ends[:, :-1]], dim=1)
    h = torch.addcmul(b, a, starts[:, :, None]).reshape(B, nc * L, di, n)
    y = torch.einsum("bsdn,bsn->bsd", h[:, :S], C)
    return y, ends[:, -1]


def mamba_discretize(cfg: ModelConfig, p, x, conv_state=None):
    """The scan's inputs from x (B, S, D): (dA, dBx (B, S, di, n) and C (B,
    S, n), float32; the convolved, activated xi and the gate z (B, S, di)
    in the compute dtype; the new conv state).  The projections and the
    convolution run in the compute dtype, the discretisation in float32."""
    cd = dtype_of(cfg.compute_dtype)
    n = cfg.ssm.state_size
    xi, z = (x.to(cd) @ p["w_in"].to(cd)).chunk(2, dim=-1)
    xi, new_conv = _causal_conv(
        xi, p["conv_w"].to(cd), p["conv_b"].to(cd),
        None if conv_state is None else conv_state.to(cd))
    xi = F.silu(xi)
    bcdt = xi @ p["w_bcdt"].to(cd)
    Bm, Cm, dt_in = bcdt.split([n, n, bcdt.shape[-1] - 2 * n], dim=-1)
    dt = _softplus((dt_in @ p["w_dt"].to(cd)).float()
                   + p["dt_bias"].float())                 # (B, S, di)
    A = -torch.exp(p["A_log"].float())                     # (di, n)
    # discretize: h_t = exp(dt A) h + dt B_t x_t
    dA = torch.exp(dt[..., None] * A)                      # (B, S, di, n)
    dBx = (dt * xi.float())[..., None] * Bm.float()[:, :, None, :]
    return dA, dBx, Cm.float(), xi, z, new_conv


def apply_mamba(cfg: ModelConfig, p, x, conv_state=None, ssm_state=None):
    """x: (B, S, D) -> (out (B, S, D), the new conv state (B, W - 1, di)
    in x's dtype, the new SSM state (B, di, n) float32).  The scan and the
    skip run in float32, the gate and the output projection in the
    compute dtype."""
    cd = dtype_of(cfg.compute_dtype)
    dA, dBx, C, xi, z, new_conv = mamba_discretize(cfg, p, x, conv_state)
    if ssm_state is None:
        B, _, di, n = dA.shape
        ssm_state = torch.zeros((B, di, n), dtype=torch.float32,
                                device=x.device)
    y, new_state = mamba_scan(dA, dBx, C, ssm_state.float())
    y = y + p["Dskip"].float() * xi.float()
    out = (y.to(cd) * F.silu(z)) @ p["w_out"].to(cd)
    return out, new_conv.to(x.dtype), new_state
