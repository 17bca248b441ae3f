"""AdamW and Adafactor with global-norm clipping, and the LR schedules, as
plain functions on tensor lists.

Port of ``repro.optim.optimizers``.  Written out rather than taken from
``torch.optim`` so the arithmetic is the reference's, element by element:
AdamW's bias correction ``m / (1 - b1**t)`` and ``v / (1 - b2**t)`` in
float32 with ``t = step + 1``, then ``p - lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p)``; Adafactor's factored second moment with no first moment, its
update-RMS clipping and its bfloat16 update direction.  Parameters,
gradients and states are sequences in one fixed order: AdamW's state is
``{"m": [...], "v": [...]}``, Adafactor's one dict per parameter, ``{"vr",
"vc"}`` for a factored matrix and ``{"v"}`` otherwise, the reference's
layouts leaf for leaf.

The update runs tensor by tensor and writes into the parameters and
states it is given, AdamW in slices of at most :data:`CHUNK` elements, so
its float32 temporaries are one slice's, never a copy of every parameter.
``update(..., donate=True)`` writes into the caller's tensors (the
reference's donated buffers); without it the update first clones them and
writes into the clones, leaving the caller's as they were.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch

CHUNK = 1 << 24            # elements per slice of an AdamW update


class Optimizer(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], object]
    update: Callable[..., Tuple[List[torch.Tensor], object]]
    # update(grads, state, params, step, donate=False)
    #   -> (new_params, new_state)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(grads: Sequence[torch.Tensor], max_norm: float):
    g = global_norm(grads)
    return torch.clamp(max_norm / (g + 1e-9), max=1.0), g


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    """Norm in float32, scaling in each gradient's own dtype."""
    scale, g = _clip_scale(grads, max_norm)
    return [x * scale.to(x.dtype) for x in grads], g


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup over ``warmup`` steps, then a cosine to 0 at
    ``total``; a float32 0-d tensor of the step's rate."""
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return fn


def constant_schedule(lr: float):
    """A constant rate; a Python float meets float32 tensors as float32."""
    return lambda step: float(lr)


def _on(lr, device):
    return lr.to(device) if torch.is_tensor(lr) else lr


def _owned(params, state, donate):
    """The tensors an update writes into: the given ones when donated,
    else contiguous clones of them."""
    if donate:
        return list(params), state
    c = lambda x: x.clone(memory_format=torch.contiguous_format)
    if isinstance(state, dict):
        state = {k: [c(x) for x in v] for k, v in state.items()}
    else:
        state = [{k: c(x) for k, x in s.items()} for s in state]
    return [c(p) for p in params], state


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr_fn, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
          max_grad_norm=0.0) -> Optimizer:
    if not callable(lr_fn):
        lr_fn = constant_schedule(lr_fn)

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {"m": zeros, "v": [z.clone() for z in zeros]}

    def leaf(p, g, m_, v_, t, lr):
        """(new p, new m, new v) of one slice of a tensor."""
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * g * g
        du = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        if weight_decay:
            du = du + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * du).to(p.dtype), m, v

    def update(grads, state, params, step, donate=False):
        params, state = _owned(params, state, donate)
        scale = _clip_scale(grads, max_grad_norm)[0] if max_grad_norm \
            else None
        dev = grads[0].device
        t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
        lr = _on(lr_fn(step), dev)
        for p, g, m_, v_ in zip(params, grads, state["m"], state["v"]):
            g = (g * scale.to(g.dtype) if scale is not None
                 else g.to(torch.float32))
            # views: the slices written below are the updated tensors
            flat = [x.view(-1) for x in (p, g.contiguous(), m_, v_)]
            for a in range(0, p.numel(), CHUNK):
                sl = [x[a:a + CHUNK] for x in flat]
                for dst, val in zip((sl[0], sl[2], sl[3]),
                                    leaf(*sl, t, lr)):
                    dst.copy_(val)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), simplified: factored v, no first moment
# ---------------------------------------------------------------------------

def adafactor(lr_fn, *, decay=0.8, eps=1e-30, clip_threshold=1.0,
              max_grad_norm=0.0, min_dim_size_to_factor=128,
              update_dtype=torch.float32) -> Optimizer:
    """``update_dtype=torch.bfloat16`` computes the update direction u in
    bfloat16 from two broadcast factors (the factored statistics stay
    float32), as the reference's 100B+ configs do; the step ``u * scale``
    is then rounded once, to the parameter's dtype, as in the reference's
    jitted update.

    A layer-stacked leaf (``ndim >= 3``, more than 4 layers, factored) is
    updated one layer slice at a time, as the reference's ``lax.map``
    does: its update-RMS clipping is then per layer, not over the stack."""
    if not callable(lr_fn):
        lr_fn = constant_schedule(lr_fn)

    def factored(shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def init(params):
        def st(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return [st(p) for p in params]

    def upd_one(p, g, s, beta, lr):
        gf = g.to(torch.float32)
        g2 = gf * gf + eps
        if "vr" in s:
            vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                min=eps)
            new_s = {"vr": vr, "vc": vc}
            if update_dtype == torch.float32:
                vhat = vr[..., None] * vc[..., None, :] / denom[..., None]
                u = gf * torch.rsqrt(vhat + eps)
            else:
                inv_r = torch.rsqrt(vr / denom + eps).to(update_dtype)
                inv_c = torch.rsqrt(vc + eps).to(update_dtype)
                u = (g.to(update_dtype) * inv_r[..., None]
                     * inv_c[..., None, :])
        else:
            vhat = beta * s["v"] + (1 - beta) * g2
            new_s = {"v": vhat}
            u = gf * torch.rsqrt(vhat + eps)
        # update clipping (RMS <= clip_threshold)
        rms = torch.sqrt(torch.mean(torch.square(u.to(torch.float32)))
                         + 1e-30)
        scale = lr / torch.clamp(rms / clip_threshold, min=1.0)
        # the product of u and the rounded scale is exact in float32 and
        # is rounded only to p's dtype, as the reference's compiled update
        # does (XLA drops the bfloat16 round trip in between)
        du = u.to(torch.float32) * scale.to(u.dtype).to(torch.float32)
        return (p - du.to(p.dtype)).to(p.dtype), new_s

    def chunked(p, s) -> bool:
        return (p.dim() >= 3 and p.shape[0] > 4 and "vr" in s
                and s["vr"].shape[:1] == p.shape[:1])

    def update(grads, state, params, step, donate=False):
        params, state = _owned(params, state, donate)
        scale = _clip_scale(grads, max_grad_norm)[0] if max_grad_norm \
            else None
        dev = grads[0].device
        t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
        beta = 1.0 - t ** (-decay)
        lr = _on(lr_fn(step), dev)
        for p, g, s in zip(params, grads, state):
            if scale is not None:
                g = g * scale.to(g.dtype)
            # one layer at a time, as the reference's lax.map
            slices = ([(p[i], g[i], {k: v[i] for k, v in s.items()})
                       for i in range(p.shape[0])] if chunked(p, s)
                      else [(p, g, s)])
            for pi, gi, si in slices:
                q, ns = upd_one(pi, gi, si, beta, lr)
                pi.copy_(q)
                for k in si:
                    si[k].copy_(ns[k])
        return params, state

    return Optimizer(init, update)


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
