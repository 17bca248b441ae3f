"""Rollout engine, synchronous path: collect -> values -> GAE -> flatten,
then the PPO update (the paper's Fig. 4 loop).

Port of the single-host sync path of ``repro.drl.engine``.  Sinks, meshes,
the async double-buffered loop and fleet mode are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.drl import networks, rollout
from repro_torch.drl.gae import gae_batch
from repro_torch.drl.ppo import Batch, PPOConfig, make_optimizer, ppo_update
from repro_torch.drl.rollout import Trajectory


class TrainCarry(NamedTuple):
    """What ``run_sync`` carries from one episode to the next, handed to
    ``on_state`` after each update: checkpointing it (with the env batch
    every episode starts from) and re-entering with it reproduces the
    remaining episodes bit for bit."""
    model: torch.nn.Module
    opt_state: dict
    step: int
    generator: Optional[torch.Generator]


@dataclass(frozen=True)
class EngineConfig:
    n_envs: int
    horizon: int              # actuation periods per episode (the paper's T)
    gamma: float = 0.99
    lam: float = 0.95


class RolloutEngine:
    """``collect`` rolls the env batch for one episode and returns the
    flattened PPO ``Batch`` with its ``Trajectory``; ``run_sync`` alternates
    collect and update for a number of episodes."""

    def __init__(self, env_step_fn: Callable, cfg: EngineConfig, *,
                 obs_aux_fn: Optional[Callable] = None):
        self.env_step_fn = env_step_fn
        self.obs_aux_fn = obs_aux_fn
        self.cfg = cfg

    @classmethod
    def for_env(cls, env, cfg: EngineConfig, **kw) -> "RolloutEngine":
        """Bind a CylinderEnv-like object; its ``obs_aux`` (probe coords +
        live-slot mask) is threaded to the policy."""
        kw.setdefault("obs_aux_fn", getattr(env, "obs_aux", None))
        return cls(env.env_step, cfg, **kw)

    @torch.no_grad()
    def postprocess(self, model, traj: Trajectory) -> Batch:
        cfg = self.cfg
        if traj.probe_mask is not None:
            aux_t = {"xy": traj.probe_xy[:, None],
                     "mask": traj.probe_mask[:, None]}
            aux_n = {"xy": traj.probe_xy, "mask": traj.probe_mask}
        else:
            aux_t = aux_n = None
        values = networks.value(model, traj.obs, aux_t)          # (N, T)
        last_v = networks.value(model, traj.last_obs, aux_n)     # (N,)
        adv, ret = gae_batch(traj.reward, values, last_v, gamma=cfg.gamma,
                             lam=cfg.lam, valid=traj.valid)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        batch = Batch(obs=flat(traj.obs), act=flat(traj.act),
                      logp_old=flat(traj.logp), adv=flat(adv),
                      ret=flat(ret))
        if traj.valid is not None:
            batch = batch._replace(valid=flat(traj.valid))
        if traj.probe_mask is not None:
            N, T = traj.obs.shape[:2]
            xy = traj.probe_xy[:, None].expand(N, T, *traj.probe_xy.shape[1:])
            m = traj.probe_mask[:, None].expand(N, T,
                                                *traj.probe_mask.shape[1:])
            batch = batch._replace(probe_xy=flat(xy), probe_mask=flat(m))
        return batch

    def collect(self, model, st_b, obs_b, *,
                generator: Optional[torch.Generator] = None, noise=None
                ) -> Tuple[Batch, Trajectory]:
        """One episode of all N_envs environments from ``(st_b, obs_b)``."""
        _, traj = rollout.rollout_batch(self.env_step_fn, model, st_b, obs_b,
                                        self.cfg.horizon,
                                        generator=generator, noise=noise,
                                        obs_aux_fn=self.obs_aux_fn)
        return self.postprocess(model, traj), traj

    def run_sync(self, model, opt_state, ppo_cfg: PPOConfig, optimizer,
                 st_b, obs_b, episodes: int, *, generator=None, step: int = 0,
                 noise: Optional[Sequence] = None,
                 perms: Optional[Sequence] = None,
                 on_episode: Optional[Callable] = None,
                 on_state: Optional[Callable] = None):
        """Sequential [collect] -> [update]; every episode starts from
        ``(st_b, obs_b)``, as in the reference.  ``noise[e]`` /
        ``perms[e]`` inject episode ``e``'s rollout noise and PPO
        permutations.  ``step`` seeds the PPO minibatch counter (a resume
        passes the stored one).  After each update ``on_episode(traj,
        metrics)`` fires, then ``on_state(TrainCarry)``: an episode that
        ``on_episode`` rejects by raising is never handed to
        ``on_state``."""
        returns = []
        for e in range(episodes):
            batch, traj = self.collect(
                model, st_b, obs_b, generator=generator,
                noise=None if noise is None else noise[e])
            opt_state, step, metrics = ppo_update(
                ppo_cfg, optimizer, model, opt_state, batch, step,
                generator=generator,
                perms=None if perms is None else perms[e])
            returns.append(float(torch.mean(torch.sum(traj.reward, dim=1))))
            if on_episode is not None:
                on_episode(traj, metrics)
            if on_state is not None:
                on_state(TrainCarry(model, opt_state, step, generator))
        return model, opt_state, np.asarray(returns)

    def init(self, pcfg: networks.PolicyConfig, ppo_cfg: PPOConfig,
             seed: int, device="cuda"):
        """(model, optimizer, opt_state, generator) for a fresh run."""
        generator = torch.Generator().manual_seed(seed)
        model = networks.init_actor_critic(pcfg, generator, device=device)
        optimizer = make_optimizer(ppo_cfg)
        opt_state = optimizer.init(list(model.parameters()))
        return model, optimizer, opt_state, generator

