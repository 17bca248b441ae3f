"""Asynchronous training: the paper's §IV future-work pointer, realized.

Port of ``repro.drl.async_train``.  The synchronous loop serializes
[collect episode] -> [PPO update]; the async variant overlaps them: episode
*e* is collected with the policy as of the update of *e-2* while the update
for *e-1*'s trajectories runs.  PPO's importance ratio r_t(theta) absorbs
the staleness (the trajectories carry their behaviour-policy log-probs).

The double-buffered loop itself is ``RolloutEngine.run_async``
(drl/engine.py): on the card the update runs on a second CUDA stream beside
the collect.  ``async_speedup`` gives the systems half from the cost model:
with updates hidden behind collection, t_episode -> max(t_collect,
t_update) + interface costs.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.core.plan import CostModel, ParallelPlan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.drl import networks
from repro_torch.drl import train_state as ts_mod
from repro_torch.drl.engine import EngineConfig, RolloutEngine
from repro_torch.drl.health import DivergenceError, resolve_watchdog
from repro_torch.drl.ppo import PPOConfig, make_optimizer


def train_async(env_step_fn, pcfg: networks.PolicyConfig, ppo_cfg: PPOConfig,
                st0_b, obs0_b, *, n_envs: int, horizon: int, episodes: int,
                seed: int = 0, sink=None, ckpt_dir: Optional[str] = None,
                ckpt_every: int = 10, ckpt_keep: int = 3, resume=None,
                watchdog=True, device: DeviceLike = "cuda",
                _rollbacks: int = 0):
    """Stale-gradient PPO: updates always consume the PREVIOUS episode's
    trajectories.  Returns (trained model, per-episode returns).

    Fault tolerance mirrors ``train()``: ``ckpt_dir`` enables periodic
    ``AsyncCheckpointer`` saves of the TrainState every ``ckpt_every``
    episodes (the one in-flight update is not part of the snapshot, see
    ``RolloutEngine.run_async``), and ``resume`` restarts from a checkpoint
    path / directory / "auto", with the env batch the checkpoint carries
    when ``st0_b`` / ``obs0_b`` are None.  ``episodes`` is the TOTAL target.

    ``watchdog`` mirrors ``TrainConfig.watchdog``: the overlapped loop does
    not wait for update metrics, so the async watchdog screens the
    per-episode return (plus injected faults) and rolls back to the last
    checkpoint (or restarts fresh without ``ckpt_dir``), bounded by
    ``WatchdogConfig.max_rollbacks``.  ``device`` is where the model lives
    (``"cuda"`` raises without a card); the env batch must be there too."""
    device = resolve_device(device)
    wd = resolve_watchdog(watchdog)
    engine = RolloutEngine(
        env_step_fn,
        EngineConfig(n_envs=n_envs, horizon=horizon,
                     gamma=ppo_cfg.gamma, lam=ppo_cfg.lam),
        sink=sink, device=device)
    src = ts_mod.resolve_resume(resume, ckpt_dir)
    step = 0
    rewards: list = []
    if src is None:
        model, optimizer, opt_state, generator = engine.init(
            pcfg, ppo_cfg, seed, device)
    else:
        optimizer = make_optimizer(ppo_cfg)
        ts, meta = ts_mod.load_train_state(src, device)
        mismatch = [f"{k}: checkpoint={meta[k]!r} current={v!r}"
                    for k, v in (("n_envs", n_envs), ("horizon", horizon))
                    if meta.get(k) is not None and meta[k] != v]
        if mismatch:
            raise ckpt_mod.CheckpointError(
                "checkpoint is incompatible with this train_async call:\n  "
                + "\n  ".join(mismatch))
        model = networks.init_actor_critic(
            pcfg, torch.Generator().manual_seed(seed), device)
        model.load_state_dict(ts.params)
        opt_state, step = ts.opt_state, ts.step
        generator = torch.Generator()
        generator.set_state(ts.rng)
        if ts.env_state is not None:
            st0_b = ts.env_state
        if ts.obs is not None:
            obs0_b = ts.obs
        rewards = [float(x) for x in np.asarray(
            ts.history.get("reward", ()))]
        engine.episode = ts.episode

    remaining = episodes - engine.episode
    if remaining <= 0:
        return model, np.asarray(rewards)

    ckpter = (ckpt_mod.AsyncCheckpointer(ckpt_dir, keep=ckpt_keep)
              if ckpt_dir else None)

    def on_episode(traj, metrics):
        r = float(torch.mean(torch.sum(traj.reward, dim=1)))
        rewards.append(r)
        if wd is not None:
            ep = len(rewards) - 1
            reason = wd.observe(None, episode=ep)
            if reason is None and not np.isfinite(r):
                reason = f"non-finite episode return ({r})"
            if reason is not None:
                raise DivergenceError(ep, reason)

    def on_state(carry):
        done = engine.episode         # episodes collected so far
        snap = ts_mod.TrainState(
            params=carry.model.state_dict(), opt_state=carry.opt_state,
            rng=carry.generator.get_state(), step=carry.step, episode=done,
            env_state=st0_b, obs=obs0_b,
            history={"reward": np.asarray(rewards)})
        ckpter.save(done, ts_mod.to_tree(snap),
                    metadata=ts_mod.state_metadata(
                        snap, {"n_envs": n_envs, "horizon": horizon}))

    divergence = None
    try:
        model, _, _ = engine.run_async(
            model, opt_state, ppo_cfg, optimizer, st0_b, obs0_b, remaining,
            generator=generator, step=step, on_episode=on_episode,
            on_state=on_state if ckpter is not None else None,
            state_every=ckpt_every)
    except DivergenceError as e:
        divergence = e
    finally:
        if ckpter is not None:
            ckpter.close()

    if divergence is not None:
        max_rb = wd.cfg.max_rollbacks if wd else 0
        if _rollbacks >= max_rb:
            raise RuntimeError(
                f"async training diverged and {_rollbacks} rollback(s) did "
                f"not clear it ({divergence}); a deterministic divergence "
                f"replays identically: adjust the PPO config or raise "
                f"WatchdogConfig.max_rollbacks") from divergence
        return train_async(
            env_step_fn, pcfg, ppo_cfg, st0_b, obs0_b, n_envs=n_envs,
            horizon=horizon, episodes=episodes, seed=seed, sink=sink,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, ckpt_keep=ckpt_keep,
            resume="auto" if ckpt_dir else None, watchdog=watchdog,
            device=device, _rollbacks=_rollbacks + 1)
    return model, np.asarray(rewards)


def async_speedup(model: CostModel, plan: ParallelPlan,
                  n_episodes: int = 3000,
                  io_bytes: Optional[float] = None) -> Dict[str, float]:
    """Systems gain of hiding the update behind collection (cost model)."""
    t_sync = model.t_training(plan, n_episodes, io_bytes)
    rounds = -(-n_episodes // plan.n_envs)
    t_ep_sync = model.t_episode(plan, io_bytes)
    t_collect = t_ep_sync - model.t_update
    t_ep_async = max(t_collect, model.t_update)
    t_async = rounds * t_ep_async + model.t_update   # drain the last update
    return {"t_sync_h": t_sync / 3600, "t_async_h": t_async / 3600,
            "speedup": t_sync / t_async}
