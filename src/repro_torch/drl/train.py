"""Single-host DRL training driver: multi-env PPO on the cylinder AFC task.

Port of the synchronous path of ``repro.drl.train``: N_envs environments
roll out one episode each from the warmed-up flow, trajectories are
batched, and PPO updates the shared policy (the paper's Fig. 4 loop).  On
the card the actuation intervals run through the fused-interval kernel
(``backend="fused"``, the default).  ``TrainConfig.scenarios`` trains one
policy on a mixed batch (for example the cylinder and the fluidic
pinball): the action width follows the batch's amplitude.  Checkpoints, sinks, plans, fleets and
the watchdog are not ported yet; the history has the reference's keys.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cfd import scenarios as scn_mod
from repro_torch.cfd.env import CylinderEnv, EnvConfig, broadcast_env_state
from repro_torch.device import resolve_device
from repro_torch.drl import networks
from repro_torch.drl.engine import EngineConfig, RolloutEngine
from repro_torch.drl.ppo import PPOConfig

HISTORY_FIELDS = ("reward", "cd", "cl", "wall", "quarantines", "grad_skips")


@dataclass
class TrainConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    ppo: PPOConfig = field(default_factory=PPOConfig)
    n_envs: int = 4
    episodes: int = 100
    seed: int = 0
    # scenario names (cfd.scenarios) assigned round-robin over the env
    # batch; None = the single case described by ``env``
    scenarios: Optional[Tuple[str, ...]] = None
    backend: str = "fused"        # solver backend of every interval
    device: str = "cuda"


def train(cfg: TrainConfig, *, log_fn: Optional[Callable] = print,
          model: Optional[networks.ActorCritic] = None,
          noise: Optional[Sequence] = None, perms: Optional[Sequence] = None,
          ) -> Tuple[Dict[str, np.ndarray], networks.ActorCritic]:
    """Returns (history dict of per-episode arrays, trained model).

    ``model`` replaces the freshly initialised policy (e.g. parameters
    converted from the reference with ``repro_torch.convert``); ``noise[e]``
    ((n_envs, T, act_dim)) and ``perms[e]`` ((epochs, n_envs * T)) inject
    episode ``e``'s rollout noise and PPO permutations."""
    device = resolve_device(cfg.device)
    env = CylinderEnv(cfg.env, backend=cfg.backend, device=device)
    if cfg.scenarios:
        # mixed-scenario batch: per-env physics, probes and action slots
        st_b, obs_b = env.reset_batch(cfg.scenarios, cfg.n_envs)
    else:
        st0, obs0 = env.reset()       # warms up + calibrates CD0
        st_b, obs_b = broadcast_env_state(st0, obs0, cfg.n_envs)
    # the policy's widths follow the reset batch: the padded probe count,
    # and the amplitude's trailing dim (per-body speeds) or 1
    obs_dim = int(obs_b.shape[-1])
    if cfg.scenarios:
        expect = scn_mod.common_obs_dim(cfg.scenarios)
        if expect != obs_dim:
            raise ValueError(
                f"observation width mismatch: scenarios "
                f"{tuple(cfg.scenarios)} pad to common_obs_dim={expect} but "
                f"the reset batch produced obs_dim={obs_dim}")
    jv = st_b.jet_vel
    act_dim = int(jv.shape[-1]) if jv.dim() > 1 else 1
    pcfg = networks.PolicyConfig(obs_dim=obs_dim, act_dim=act_dim)
    engine = RolloutEngine.for_env(
        env, EngineConfig(n_envs=cfg.n_envs,
                          horizon=cfg.env.actions_per_episode,
                          gamma=cfg.ppo.gamma, lam=cfg.ppo.lam))
    fresh, optimizer, _, generator = engine.init(pcfg, cfg.ppo, cfg.seed,
                                                 device)
    model = fresh if model is None else model.to(device)
    opt_state = optimizer.init(list(model.parameters()))

    hist = {f: [] for f in HISTORY_FIELDS}
    t_ep = [time.perf_counter()]

    def on_episode(traj, metrics):
        ep = len(hist["reward"])
        r = float(torch.mean(torch.sum(traj.reward, dim=1)))
        cd = float(torch.mean(traj.cd[:, -10:]))
        cl = float(torch.mean(torch.abs(traj.cl[:, -10:])))
        quar = (0.0 if traj.valid is None
                else float(torch.sum(1.0 - traj.valid)))
        skips = float(metrics.get("grad_skips", 0.0))
        now = time.perf_counter()
        for k, x in (("reward", r), ("cd", cd), ("cl", cl),
                     ("wall", now - t_ep[0]), ("quarantines", quar),
                     ("grad_skips", skips)):
            hist[k].append(x)
        t_ep[0] = now
        if log_fn and (quar or skips):
            log_fn(f"ep {ep:4d}  health: {quar:.0f} env-step(s) "
                   f"quarantined, {skips:.0f} update(s) skipped")
        if log_fn and (ep % max(1, cfg.episodes // 20) == 0
                       or ep == cfg.episodes - 1):
            log_fn(f"ep {ep:4d}  return {r:+8.3f}  CD(tail) {cd:.3f}  "
                   f"|CL| {cl:.3f}  {hist['wall'][-1]:.1f}s")

    model, _, _ = engine.run_sync(model, opt_state, cfg.ppo, optimizer,
                                  st_b, obs_b, cfg.episodes,
                                  generator=generator, noise=noise,
                                  perms=perms, on_episode=on_episode)
    return {k: np.asarray(v) for k, v in hist.items()}, model
