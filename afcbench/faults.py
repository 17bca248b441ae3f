"""Faults planted underneath the timed path, for the test that sees
``correct`` come out false for each fault a cell can have (and for the
readings that set the limits): each is a context manager that patches the
program while it is entered."""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def _patched(obj, name: str, fn) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, fn(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def interval_unchanged():
    """The interval returns the state it was given (its coefficients
    computed)."""
    from repro_torch.kernels.actuation import ops

    def wrap(real):
        def fused_interval(cfg, geom_arrays, state, *a, **kw):
            _, outs = real(cfg, geom_arrays, state, *a, **kw)
            return state, outs
        return fused_interval
    return _patched(ops, "fused_interval", wrap)


def answer_altered():
    """The first env's drag coefficient altered by 1% where the interval
    produces it."""
    from repro_torch.kernels.actuation import ops

    def wrap(real):
        def fused_interval(*a, **kw):
            flow, outs = real(*a, **kw)
            cd = outs.cd.clone()
            cd[0] = cd[0] * 1.01
            return flow, outs._replace(cd=cd)
        return fused_interval
    return _patched(ops, "fused_interval", wrap)


def update_unchanged():
    """The PPO update leaves the parameters as it found them."""
    from repro_torch.drl import engine

    def wrap(real):
        def ppo_update(cfg, optimizer, model, opt_state, *a, **kw):
            saved = [p.detach().clone() for p in model.parameters()]
            _, step, metrics = real(cfg, optimizer, model, opt_state, *a,
                                    **kw)
            with torch.no_grad():
                for p, s in zip(model.parameters(), saved):
                    p.copy_(s)
            return opt_state, step, metrics
        return ppo_update
    return _patched(engine, "ppo_update", wrap)


def half_batch():
    """Each minibatch's loss over its first half, the mean taken over the
    rest."""
    from repro_torch.drl import ppo

    def wrap(real):
        def ppo_loss(cfg, model, batch):
            half = batch.obs.shape[0] // 2
            return real(cfg, model, type(batch)(*(
                None if x is None else x[:half] for x in batch)))
        return ppo_loss
    return _patched(ppo, "ppo_loss", wrap)


# the exchange between chips is no fault of these one-chip cells
FAULTS: Dict[str, object] = {
    "interval_unchanged": interval_unchanged,
    "update_unchanged": update_unchanged,
    "half_batch": half_batch,
    "answer_altered": answer_altered,
}
