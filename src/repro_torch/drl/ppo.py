"""Proximal Policy Optimization (clipped surrogate, eq. 10 of the paper).

Port of ``repro.drl.ppo``; gradients come from autograd, the update from
``optim.adamw`` on the module's parameters in ``model.parameters()`` order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Generator, NamedTuple, Optional, Tuple

import torch

from repro_torch.drl import networks
from repro_torch.optim.optimizers import adamw, global_norm
from repro_torch.testing import faults


@dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    clip_eps: float = 0.2          # epsilon in eq. (10)
    gamma: float = 0.99
    lam: float = 0.95
    epochs: int = 10
    minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 0.003
    max_grad_norm: float = 0.5
    normalize_adv: bool = True
    skip_nonfinite_grads: bool = True   # reject (don't apply) NaN/Inf updates


class Batch(NamedTuple):
    obs: torch.Tensor        # (N, obs_dim)
    act: torch.Tensor        # (N, act_dim)
    logp_old: torch.Tensor   # (N,)
    adv: torch.Tensor        # (N,)
    ret: torch.Tensor        # (N,)
    probe_xy: torch.Tensor = None    # (N, obs_dim, 2)
    probe_mask: torch.Tensor = None  # (N, obs_dim)
    valid: torch.Tensor = None       # (N,) sentinel mask: 1 = healthy sample


def make_optimizer(cfg: PPOConfig):
    return adamw(cfg.lr, max_grad_norm=cfg.max_grad_norm)


def _std(x):
    return torch.std(x, correction=0)


def ppo_loss(cfg: PPOConfig, model, batch: Batch):
    """Clipped-surrogate loss.  With a sentinel validity mask the loss is
    computed with both the plain reductions and masked ``sum(x*m)/sum(m)``
    ones, and ``where(all_valid, plain, masked)`` selects per scalar, as
    the reference does (an all-healthy batch takes the plain values)."""
    aux = (None if batch.probe_mask is None
           else {"xy": batch.probe_xy, "mask": batch.probe_mask})
    logp = networks.log_prob(model, batch.obs, batch.act, aux)
    ratio = torch.exp(logp - batch.logp_old)                  # r_t(theta)
    v = networks.value(model, batch.obs, aux)

    def parts(mean_fn, std_fn):
        adv = batch.adv
        if cfg.normalize_adv:
            adv = (adv - mean_fn(batch.adv)) / (std_fn(batch.adv) + 1e-8)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        return (-mean_fn(torch.minimum(unclipped, clipped)),   # eq. (10)
                0.5 * mean_fn((v - batch.ret) ** 2),
                mean_fn(batch.logp_old - logp),
                mean_fn((torch.abs(ratio - 1)
                         > cfg.clip_eps).to(torch.float32)))

    if batch.valid is None:
        policy_loss, value_loss, approx_kl, clip_frac = parts(torch.mean,
                                                              _std)
    else:
        m = batch.valid
        n = torch.clamp(torch.sum(m), min=1.0)

        def mmean(x):
            return torch.sum(x * m) / n

        def mstd(x):
            return torch.sqrt(mmean((x - mmean(x)) ** 2))

        all_ok = torch.all(m > 0.5)
        policy_loss, value_loss, approx_kl, clip_frac = (
            torch.where(all_ok, h, d)
            for h, d in zip(parts(torch.mean, _std), parts(mmean, mstd)))
    ent = networks.entropy(model)
    loss = (policy_loss + cfg.value_coef * value_loss
            - cfg.entropy_coef * ent)
    metrics = {"policy_loss": policy_loss, "value_loss": value_loss,
               "entropy": ent, "approx_kl": approx_kl,
               "clip_frac": clip_frac}
    return loss, metrics


def ppo_update(cfg: PPOConfig, optimizer, model, opt_state, batch: Batch,
               step: int, *, generator: Optional[torch.Generator] = None,
               perms=None) -> Tuple[dict, int, Dict[str, torch.Tensor]]:
    """``epochs`` passes of ``minibatches`` shuffled splits, updating
    ``model`` in place; returns ``(opt_state, step, metrics)``.
    :func:`ppo_update_steps` run to its end."""
    steps = ppo_update_steps(cfg, optimizer, model, opt_state, batch, step,
                             generator=generator, perms=perms)
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def ppo_update_steps(cfg: PPOConfig, optimizer, model, opt_state,
                     batch: Batch, step: int, *,
                     generator: Optional[torch.Generator] = None, perms=None
                     ) -> Generator[None, None,
                                    Tuple[dict, int,
                                          Dict[str, torch.Tensor]]]:
    """The PPO update as a generator: it pauses after each minibatch's
    gradients and after each minibatch's parameter update (``2 * epochs *
    minibatches`` pauses) and returns ``(opt_state, step, metrics)``, so a
    caller can interleave it with other work (``RolloutEngine.run_async``).

    ``perms`` (optional, (epochs, n)) injects each epoch's permutation;
    otherwise it is drawn from ``generator``.  ``step`` counts minibatch
    updates (it indexes Adam's bias correction) and advances whether or not
    an update is applied; with ``skip_nonfinite_grads`` a non-finite
    gradient leaves params and moments unchanged and is counted (the
    ``grad_nan`` fault of ``repro_torch.testing.faults`` poisons the
    minibatch whose ``step`` it names)."""
    params = list(model.parameters())
    n = batch.obs.shape[0]
    mb = n // cfg.minibatches
    dev = batch.obs.device
    history = []
    for e in range(cfg.epochs):
        if perms is not None:
            perm = torch.as_tensor(perms[e], dtype=torch.int64, device=dev)
        else:
            perm = torch.randperm(n, generator=generator).to(dev)
        shuffled = Batch(*(None if x is None else x[perm] for x in batch))
        for i in range(cfg.minibatches):
            sl = Batch(*(None if x is None else x[i * mb:(i + 1) * mb]
                         for x in shuffled))
            loss, metrics = ppo_loss(cfg, model, sl)
            grads = torch.autograd.grad(loss, params)
            fz = faults.active("grad_nan")
            if fz is not None and step == int(fz.get("step", 0)):
                grads = [g + float("nan") for g in grads]
            yield
            with torch.no_grad():
                new_p, new_o = optimizer.update(grads, opt_state, params,
                                                step)
                if cfg.skip_nonfinite_grads:
                    gnorm = global_norm(grads)
                    ok = torch.isfinite(gnorm)
                    new_p = [torch.where(ok, a, b)
                             for a, b in zip(new_p, params)]
                    new_o = {k: [torch.where(ok, a, b) for a, b in
                                 zip(new_o[k], opt_state[k])]
                             for k in new_o}
                    metrics = dict(metrics,
                                   grad_norm=torch.where(ok, gnorm, 0.0),
                                   grad_skips=1.0 - ok.to(torch.float32))
                for p, q in zip(params, new_p):
                    p.copy_(q)
            opt_state = new_o
            step += 1
            history.append({k: v.detach() for k, v in metrics.items()})
            yield
    out = {k: torch.mean(torch.stack([h[k] for h in history]))
           for k in history[0] if k != "grad_skips"}
    if "grad_skips" in history[0]:
        out["grad_skips"] = torch.sum(torch.stack(
            [h["grad_skips"] for h in history]))
    return opt_state, step, out
