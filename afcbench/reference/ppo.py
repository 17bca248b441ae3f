"""The plain reference of the agent: the paper's 2x512 tanh actor-critic
with a state-independent log-std (Rabault et al.), generalized advantage
estimation, and the clipped PPO update (eq. 10) with AdamW and global-norm
clipping, in float32 PyTorch on a dict of parameter tensors.

``tf32=True`` rounds every product's operands to TF32 (10 mantissa bits,
round to nearest): the precision a float32 matmul drops to when TF32 is
allowed, on any device; the benchmark's control computes so.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

LOG_2PI = math.log(2 * math.pi)


@dataclass(frozen=True)
class PPO:
    lr: float = 3e-4
    clip_eps: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    epochs: int = 10
    minibatches: int = 4
    value_coef: float = 0.5
    entropy_coef: float = 0.003
    max_grad_norm: float = 0.5
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def layer_names(depth: int = 2) -> List[str]:
    """Parameter names in the order the update walks them: the actor's
    layers, the critic's, then the log-std."""
    names = []
    for net in ("actor", "critic"):
        for i in range(depth + 1):
            names += [f"{net}.{i}.weight", f"{net}.{i}.bias"]
    return names + ["log_std"]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _linear(x, w, b, tf32: bool):
    if tf32:
        # straight-through: the forward sees the rounded operands
        x = x + (tf32_round(x) - x).detach()
        w = w + (tf32_round(w) - w).detach()
    return torch.nn.functional.linear(x, w, b)


def _mlp(p: Dict[str, torch.Tensor], net: str, x, depth: int, tf32: bool):
    for i in range(depth + 1):
        x = _linear(x, p[f"{net}.{i}.weight"], p[f"{net}.{i}.bias"], tf32)
        if i < depth:
            x = torch.tanh(x)
    return x


def mean_action(p, obs, mask, depth: int = 2, tf32: bool = False):
    """The policy's mean action in [-1, 1] on the masked probes."""
    return torch.tanh(_mlp(p, "actor", obs * mask, depth, tf32))


def value(p, obs, mask, depth: int = 2, tf32: bool = False):
    return _mlp(p, "critic", obs * mask, depth, tf32)[..., 0]


def log_prob(act, mean, log_std):
    var = torch.exp(2 * log_std)
    return torch.sum(-0.5 * ((act - mean) ** 2 / var + 2 * log_std
                             + LOG_2PI), dim=-1)


def gae(reward, values, last_value, gamma: float, lam: float, valid=None):
    """Advantages and returns of (N, T) episodes bootstrapped with V(s_T);
    a quarantined step (``valid`` 0) zeroes its advantage and cuts the
    recursion."""
    v_next = torch.cat([values[:, 1:], last_value[:, None]], dim=1)
    delta = reward + gamma * v_next - values
    adv = torch.zeros_like(delta)
    run = torch.zeros_like(delta[:, 0])
    for t in reversed(range(delta.shape[1])):
        run = delta[:, t] + gamma * lam * run
        if valid is not None:
            run = valid[:, t] * run
        adv[:, t] = run
    return adv, adv + values


def _loss(cfg: PPO, p, obs, mask, act, logp_old, adv, ret, depth, tf32):
    mean = mean_action(p, obs, mask, depth, tf32)
    logp = log_prob(act, mean, p["log_std"])
    ratio = torch.exp(logp - logp_old)
    v = value(p, obs, mask, depth, tf32)
    a = (adv - adv.mean()) / (torch.std(adv, correction=0) + 1e-8)
    surrogate = torch.minimum(ratio * a, torch.clamp(
        ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * a)
    pl = -surrogate.mean()
    vl = 0.5 * ((v - ret) ** 2).mean()
    ent = torch.sum(0.5 * (1 + LOG_2PI) + p["log_std"])
    return pl + cfg.value_coef * vl - cfg.entropy_coef * ent


def adam_init(p) -> Dict[str, Dict[str, torch.Tensor]]:
    return {"m": {k: torch.zeros_like(x) for k, x in p.items()},
            "v": {k: torch.zeros_like(x) for k, x in p.items()}}


def loss(cfg: PPO, p: Dict[str, torch.Tensor], mb: dict, depth: int = 2,
         tf32: bool = False) -> torch.Tensor:
    """The loss on one minibatch (obs, mask, act, logp_old, adv, ret) at
    parameters ``p``."""
    return _loss(cfg, p, mb["obs"], mb["mask"], mb["act"], mb["logp_old"],
                 mb["adv"], mb["ret"], depth, tf32)


def gradient(cfg: PPO, p: Dict[str, torch.Tensor], mb: dict,
             depth: int = 2, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The loss's gradient on one minibatch at parameters ``p``."""
    leaves = {k: x.detach().requires_grad_(True) for k, x in p.items()}
    with torch.enable_grad():
        grads = torch.autograd.grad(loss(cfg, leaves, mb, depth, tf32),
                                    list(leaves.values()))
    return dict(zip(leaves, grads))


def adam_step(cfg: PPO, p, opt, grads, step: int):
    """One AdamW step (bias-corrected at ``step + 1``) on the gradient
    clipped to ``max_grad_norm`` in global norm; a gradient that is not
    finite leaves the parameters and moments as they were."""
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not bool(torch.isfinite(norm)):
            return p, opt
        scale = torch.clamp(cfg.max_grad_norm / (norm + 1e-9), max=1.0)
        t = float(step + 1)
        new_p, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            g = g * scale
            m = cfg.b1 * opt["m"][k] + (1 - cfg.b1) * g
            v = cfg.b2 * opt["v"][k] + (1 - cfg.b2) * g * g
            du = (m / (1 - cfg.b1 ** t)) / (
                torch.sqrt(v / (1 - cfg.b2 ** t)) + cfg.eps)
            new_p[k], new_m[k], new_v[k] = p[k].detach() - cfg.lr * du, m, v
    return new_p, {"m": new_m, "v": new_v}


def update(cfg: PPO, p: Dict[str, torch.Tensor], opt, batch, perms,
           step: int, depth: int = 2, tf32: bool = False
           ) -> Tuple[Dict[str, torch.Tensor], dict, int]:
    """``epochs`` passes of ``minibatches`` splits of ``batch`` (rows
    flattened) in the order ``perms`` gives, a gradient and an AdamW step
    each.  Returns the new parameters and moments and the step count."""
    n = batch["obs"].shape[0]
    mb = n // cfg.minibatches
    for e in range(cfg.epochs):
        perm = perms[e].to(batch["obs"].device)
        shuf = {k: x[perm] for k, x in batch.items()}
        for i in range(cfg.minibatches):
            sl = {k: x[i * mb:(i + 1) * mb] for k, x in shuf.items()}
            g = gradient(cfg, p, sl, depth, tf32)
            p, opt = adam_step(cfg, p, opt, g, step)
            step += 1
    return p, opt, step


def episode_batch(cfg: PPO, p, obs, mask, act, reward, last_obs,
                  valid: Optional[torch.Tensor] = None, depth: int = 2,
                  tf32: bool = False):
    """An episode's (N, T) arrays -> the update's flattened batch: the
    behaviour log-probabilities and the values under ``p``, then GAE."""
    with torch.no_grad():
        mean = mean_action(p, obs, mask[:, None], depth, tf32)
        logp = log_prob(act, mean, p["log_std"])
        vals = value(p, obs, mask[:, None], depth, tf32)
        last = value(p, last_obs, mask, depth, tf32)
        adv, ret = gae(reward, vals, last, cfg.gamma, cfg.lam, valid)
    n, t = obs.shape[:2]

    def flat(x):
        return x.reshape((n * t,) + tuple(x.shape[2:]))

    return {"obs": flat(obs), "act": flat(act), "logp_old": flat(logp),
            "adv": flat(adv), "ret": flat(ret),
            "mask": mask[:, None].expand(n, t, mask.shape[-1]).reshape(
                n * t, -1)}, logp
