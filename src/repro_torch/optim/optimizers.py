"""AdamW with global-norm clipping, as plain functions on tensor lists.

Port of ``repro.optim.optimizers`` (``global_norm``, ``clip_by_global_norm``,
``constant_schedule``, ``adamw``).  Written out rather than taken from
``torch.optim.Adam`` so the bias-correction arithmetic is the reference's:
``m / (1 - b1**t)`` and ``v / (1 - b2**t)`` in float32 with ``t = step +
1``, then ``p - lr * m_hat / (sqrt(v_hat) + eps)``.  Parameters, gradients
and moments are sequences of tensors in one fixed order.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence, Tuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Sequence[torch.Tensor]], dict]
    update: Callable[..., Tuple[List[torch.Tensor], dict]]
    # update(grads, state, params, step) -> (new_params, new_state)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    g = global_norm(grads)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return [x * scale.to(x.dtype) for x in grads], g


def constant_schedule(lr: float):
    """A constant rate; a Python float meets float32 tensors as float32."""
    return lambda step: float(lr)


def adamw(lr_fn, *, b1=0.9, b2=0.999, eps=1e-8,
          max_grad_norm=0.0) -> Optimizer:
    if not callable(lr_fn):
        lr_fn = constant_schedule(lr_fn)

    def init(params):
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return {"m": zeros, "v": [z.clone() for z in zeros]}

    def update(grads, state, params, step):
        if max_grad_norm:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        else:
            grads = [g.to(torch.float32) for g in grads]
        dev = grads[0].device
        t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
        lr = lr_fn(step)
        m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], grads)]
        v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], grads)]
        mh = [m_ / (1 - b1 ** t) for m_ in m]
        vh = [v_ / (1 - b2 ** t) for v_ in v]
        new_params = []
        for p, m_, v_ in zip(params, mh, vh):
            du = m_ / (torch.sqrt(v_) + eps)
            new_params.append((p.to(torch.float32) - lr * du).to(p.dtype))
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)
