"""Generalized Advantage Estimation (a reverse loop over T).

Port of ``repro.drl.gae``.  Works on ``(..., T)`` with any leading env
dims, so ``gae_batch`` is ``gae`` itself.
"""
from __future__ import annotations

import torch


def gae(rewards, values, last_value, *, gamma: float = 0.99,
        lam: float = 0.95, valid=None):
    """rewards, values: (..., T); last_value: (...,) -> (advantages, returns).

    Fixed-length episodes bootstrap with V(s_T).  ``valid`` ((..., T) of
    1.0/0.0 from the divergence sentinel) zeroes a quarantined step's
    advantage AND cuts the recursion through it, like an episode boundary.
    """
    v_next = torch.cat([values[..., 1:], last_value[..., None]], dim=-1)
    deltas = rewards + gamma * v_next - values
    carry = torch.zeros_like(deltas[..., 0])
    advs = [None] * deltas.shape[-1]
    for t in reversed(range(deltas.shape[-1])):
        carry = deltas[..., t] + gamma * lam * carry
        if valid is not None:
            carry = valid[..., t] * carry
        advs[t] = carry
    advs = torch.stack(advs, dim=-1)
    return advs, advs + values


def gae_batch(rewards, values, last_values, *, valid=None, **kw):
    """(N_env, T) batched version (``gae`` batches over leading dims)."""
    return gae(rewards, values, last_values, valid=valid, **kw)
