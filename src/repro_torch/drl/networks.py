"""Actor-critic networks.  The paper's policy: 2x512 tanh MLP (Rabault et
al.), Gaussian head with state-independent log-std; separate value MLP.

Port of the MLP path of ``repro.drl.networks`` as an ``nn.Module``
(:class:`ActorCritic`) plus the reference's functional entry points, which
take the module where ``repro`` took a parameter tree.  ``aux``
(``{"xy", "mask"}``, see ``CylinderEnv.obs_aux``) multiplies the
observation by its live-probe mask, as the reference does whenever aux is
present; ``aux=None`` feeds the raw observation.  The attention policy is
not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device

POLICIES = ("mlp",)


class PolicyConfig(NamedTuple):
    obs_dim: int = 149
    act_dim: int = 1
    hidden: int = 512
    depth: int = 2
    init_log_std: float = -0.5
    policy: str = "mlp"


def _mlp(sizes, generator: Optional[torch.Generator]) -> nn.ModuleList:
    layers = nn.ModuleList()
    for a, b in zip(sizes[:-1], sizes[1:]):
        lin = nn.Linear(a, b)
        with torch.no_grad():
            # truncated-normal fan-in init (the reference's dense_init)
            std = 1.0 / math.sqrt(a)
            nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            lin.bias.zero_()
        layers.append(lin)
    return layers


def _mlp_apply(layers: nn.ModuleList, x, final_linear: bool = True):
    for i, lyr in enumerate(layers):
        x = lyr(x)
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


class ActorCritic(nn.Module):
    """Separate actor and critic MLPs and a state-independent log-std.

    ``nn.Linear`` stores ``(out, in)`` weights; the reference's ``(in,
    out)`` ``w`` converts with a transpose (``repro_torch.convert``).
    Built on the CPU (where ``generator`` draws); move it with ``.to``."""

    def __init__(self, cfg: PolicyConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}; the port has "
                             f"{POLICIES}")
        self.cfg = cfg
        sizes = [cfg.obs_dim] + [cfg.hidden] * cfg.depth
        self.actor = _mlp(sizes + [cfg.act_dim], generator)
        self.critic = _mlp(sizes + [1], generator)
        self.log_std = nn.Parameter(torch.full(
            (cfg.act_dim,), cfg.init_log_std, dtype=torch.float32))


def init_actor_critic(cfg: PolicyConfig, generator: torch.Generator,
                      device="cuda") -> ActorCritic:
    return ActorCritic(cfg, generator=generator).to(resolve_device(device))


def _features(obs, aux):
    if aux is not None:
        obs = obs * aux["mask"].to(obs.dtype)
    return obs


def policy_dist(model: ActorCritic, obs, aux=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mean (..., act_dim), log_std (act_dim,)); mean squashed to [-1,1]."""
    mean = torch.tanh(_mlp_apply(model.actor, _features(obs, aux)))
    return mean, model.log_std


def value(model: ActorCritic, obs, aux=None) -> torch.Tensor:
    return _mlp_apply(model.critic, _features(obs, aux))[..., 0]


def _gauss_logp(act, mean, log_std):
    var = torch.exp(2 * log_std)
    lp = -0.5 * ((act - mean) ** 2 / var + 2 * log_std
                 + math.log(2 * math.pi))
    return torch.sum(lp, dim=-1)


def sample_action(model: ActorCritic, obs, *,
                  generator: Optional[torch.Generator] = None, eps=None,
                  aux=None):
    """-> (action, log_prob).  ``eps`` (shaped like the mean) injects the
    standard-normal noise; otherwise it is drawn from ``generator``."""
    mean, log_std = policy_dist(model, obs, aux)
    std = torch.exp(log_std)
    if eps is None:
        # drawn on the generator's (CPU) device, then moved
        eps = torch.randn(mean.shape, generator=generator).to(mean.device)
    act = mean + std * eps
    return act, _gauss_logp(act, mean, log_std)


def log_prob(model: ActorCritic, obs, act, aux=None):
    mean, log_std = policy_dist(model, obs, aux)
    return _gauss_logp(act, mean, log_std)


def entropy(model: ActorCritic) -> torch.Tensor:
    return torch.sum(0.5 * (1 + math.log(2 * math.pi)) + model.log_std)
