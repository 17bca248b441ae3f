"""Single-host DRL training driver: multi-env PPO on the cylinder AFC task.

Port of the synchronous path of ``repro.drl.train``: N_envs environments
roll out one episode each from the warmed-up flow, trajectories are
batched, and PPO updates the shared policy (the paper's Fig. 4 loop).  On
the card the actuation intervals run through the fused-interval kernel
(``backend="fused"``, the default).  ``TrainConfig.scenarios`` trains one
policy on a mixed batch (for example the cylinder and the fluidic
pinball): the action width follows the batch's amplitude.
``TrainConfig.policy`` picks the 2x512 MLP or the attention set encoder.

Fault tolerance, as in the reference: with ``ckpt_dir`` set, an
``AsyncCheckpointer`` persists the full ``TrainState`` (params, Adam
moments, the rollout generator's state, PPO step, env batch, history)
every ``ckpt_every`` episodes, the write on a background thread.
``resume=`` restarts from the latest valid checkpoint with no warmup and
no reset, bitwise identical to an uninterrupted run on the same device.
The watchdog (``drl/health.py``) rolls a diverging run back to its last
healthy checkpoint and replays it, a bounded number of times.

The paper's I/O layer, as in the reference: ``TrainConfig.sink`` (or an
explicit ``sink=``) spills every episode's trajectories, a dataset sink
recording the run fingerprint in its manifest, so the run can be replayed
offline (``RolloutEngine.replay_sync``); ``interface=`` routes each
episode's PPO batch through the CFD<->DRL file interface
(``core.interface.MultiEnvInterface``).  Plans and fleets are not ported
yet; the history has the reference's keys.

Fresh and resumed runs share one loop: both build the model, optimizer
state, generator and env batch first (fresh from the seed and a warmup,
resumed from the checkpoint), and the loop only reads those.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cfd import grid as grid_mod
from repro_torch.cfd import scenarios as scn_mod
from repro_torch.cfd.env import CylinderEnv, EnvConfig, broadcast_env_state
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.device import resolve_device
from repro_torch.drl import networks
from repro_torch.drl import train_state as ts_mod
from repro_torch.drl.engine import (EngineConfig, RolloutEngine, SinkSpec,
                                    TrajectorySink)
from repro_torch.drl.health import DivergenceError, resolve_watchdog
from repro_torch.drl.ppo import PPOConfig, make_optimizer
from repro_torch.drl.train_state import HISTORY_FIELDS, TrainState

# the self-healing counters train() reports in ``health`` and stores in
# every checkpoint's metadata
HEALTH_FIELDS = ("quarantines", "grad_skips", "rollbacks", "sink_retries")


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
    # policy architecture: "mlp" (the paper's 2x512 tanh MLP) |
    # "attention" (permutation-invariant set encoder over (x, y, p) probe
    # tokens; serves mixed and variable sensor sets)
    policy: str = "mlp"
    # fault tolerance: with ckpt_dir set, the TrainState is saved every
    # ckpt_every episodes (and at the final one) via an AsyncCheckpointer
    # (keep newest ckpt_keep; background write unless ckpt_async=False)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    ckpt_keep: int = 3
    ckpt_async: bool = True
    ckpt_compress: bool = True
    # resume: None (fresh run) | True / "latest" (latest valid checkpoint in
    # ckpt_dir, error when none) | "auto" (same, but fresh when the dir has
    # none yet) | an explicit .ckpt path or checkpoint directory.
    # ``episodes`` is the TOTAL target: resuming a 40-episode checkpoint
    # with episodes=100 runs 60 more.
    resume: Any = None
    # training-health watchdog (drl/health.py): True = default thresholds,
    # a WatchdogConfig for custom ones, False/None = off.  On a trip the run
    # rolls back to the last healthy checkpoint (a fresh restart when
    # ckpt_dir is unset) and replays, bounded by max_rollbacks.
    watchdog: Any = True
    # trajectory spill: one SinkSpec for every strategy ('none' | 'memory' |
    # 'binary' | 'zstd' | 'dataset'); an explicit sink= to train() wins.
    # The run fingerprint (run_metadata) is annotated into dataset manifests.
    sink: Optional[SinkSpec] = None
    backend: str = "fused"        # solver backend of every interval
    device: str = "cuda"


def train(cfg: TrainConfig, *, log_fn: Optional[Callable] = print,
          model: Optional[torch.nn.Module] = None,
          noise: Optional[Sequence] = None, perms: Optional[Sequence] = None,
          interface=None, sink: Optional[TrajectorySink] = None,
          on_episode: Optional[Callable] = None,
          health: Optional[Dict[str, Any]] = None,
          _rollbacks: int = 0, _sink_retries0: int = 0,
          ) -> Tuple[Dict[str, np.ndarray], torch.nn.Module]:
    """Returns (history dict of per-episode arrays, trained model).

    ``model`` replaces the freshly initialised policy of a fresh run (e.g.
    parameters converted from the reference with ``repro_torch.convert``);
    a resumed run takes the checkpoint's.  ``noise[e]`` ((n_envs, T,
    act_dim)) and ``perms[e]`` ((epochs, n_envs * T)) inject episode
    ``e``'s rollout noise and PPO permutations, ``e`` counted from the
    run's first episode.  ``interface`` (a ``MultiEnvInterface``) gets
    each episode's PPO batch between collect and update.  ``sink`` spills
    the episodes in place of the one ``cfg.sink`` would build.
    ``on_episode(traj, metrics)`` is an extra per-episode hook; it fires
    after the built-in logging.  ``health`` (optional dict, filled in
    place) receives the self-healing counters (quarantines, grad_skips,
    rollbacks, sink_retries: the numbers stored under ``"health"`` in
    checkpoint metadata) and, with ``ckpt_dir``, the
    checkpoint writer's ``ckpt_saves``, ``ckpt_bytes``,
    ``ckpt_time_blocked`` (caller-visible seconds) and
    ``ckpt_time_waited`` (the part of it spent waiting for the previous
    write), summed over rollbacks.
    ``_rollbacks`` / ``_sink_retries0`` are internal: the watchdog-rollback
    retry depth and the retries counted by the sinks of rolled-back runs."""
    device = resolve_device(cfg.device)
    env = CylinderEnv(cfg.env, backend=cfg.backend, device=device)
    ts: Optional[TrainState] = None
    src = ts_mod.resolve_resume(cfg.resume, cfg.ckpt_dir)
    if src is not None:
        # resume: the checkpointed env batch IS the developed flow: no
        # warmup, no reset
        ts, ckpt_meta = ts_mod.load_train_state(src, device)
        if ts.env_state is None or ts.obs is None:
            raise ckpt_mod.CheckpointError(
                f"{src} holds no env batch to resume training from")
        st_b, obs_b = ts.env_state, ts.obs
    elif cfg.scenarios:
        # mixed-scenario batch: per-env physics, probes and action slots
        st_b, obs_b = env.reset_batch(cfg.scenarios, cfg.n_envs)
    else:
        st0, obs0 = env.reset()       # warms up + calibrates CD0
        st_b, obs_b = broadcast_env_state(st0, obs0, cfg.n_envs)
    # the policy's widths follow the batch: the padded probe count, and
    # the amplitude's trailing dim (per-body speeds) or 1
    obs_dim = int(obs_b.shape[-1])
    if cfg.scenarios and ts is None:
        expect = scn_mod.common_obs_dim(cfg.scenarios)
        if expect != obs_dim:
            raise ValueError(
                f"observation width mismatch: scenarios "
                f"{tuple(cfg.scenarios)} pad to common_obs_dim={expect} but "
                f"the reset batch produced obs_dim={obs_dim}")
    jv = st_b.jet_vel
    act_dim = int(jv.shape[-1]) if jv.dim() > 1 else 1
    pcfg = networks.PolicyConfig(obs_dim=obs_dim, act_dim=act_dim,
                                 policy=cfg.policy)
    engine = RolloutEngine.for_env(
        env, EngineConfig(n_envs=cfg.n_envs,
                          horizon=cfg.env.actions_per_episode,
                          gamma=cfg.ppo.gamma, lam=cfg.ppo.lam,
                          sink=cfg.sink), sink=sink)
    run_meta = ts_mod.run_metadata(
        n_envs=cfg.n_envs, obs_dim=obs_dim, seed=cfg.seed,
        grid=cfg.env.grid, horizon=cfg.env.actions_per_episode,
        steps_per_action=cfg.env.steps_per_action, scenarios=cfg.scenarios,
        policy={"policy": cfg.policy, "obs_dim": obs_dim,
                "act_dim": act_dim})
    if engine.sink is not None:
        # durable datasets record which run (and which code) produced them
        engine.sink.annotate(**run_meta)

    init_model = None if model is None else copy.deepcopy(model)
    if ts is None:
        fresh, optimizer, _, generator = engine.init(pcfg, cfg.ppo,
                                                     cfg.seed, device)
        model = fresh if model is None else model.to(device)
        opt_state = optimizer.init(list(model.parameters()))
        step = 0
        hist = {f: [] for f in HISTORY_FIELDS}
    else:
        for note in ts_mod.check_resume_compatible(ckpt_meta, run_meta):
            if log_fn:
                log_fn(note)
        if cfg.scenarios:
            # the env steps the restored batch over the geometry bank, which
            # a resume builds without the warmup; each env's geom_id must
            # index the slot of its own geometry
            scns = env.batch_scenarios(cfg.scenarios, cfg.n_envs)
            want = [grid_mod.geometry_index(s.geometry) for s in scns]
            got = ts.env_state.scn.geom_id.reshape(-1).tolist()
            if got != want:
                raise ckpt_mod.CheckpointError(
                    f"{src}: the env batch's geom_id {got} does not index "
                    f"the geometry bank slots {want} of scenarios "
                    f"{tuple(cfg.scenarios)}")
        if log_fn:
            if model is not None:
                log_fn("model= ignored: a resumed run takes the "
                       "checkpoint's params")
            log_fn(f"resume: {src} @ episode {ts.episode}")
        model = networks.init_actor_critic(
            pcfg, torch.Generator().manual_seed(cfg.seed), device)
        model.load_state_dict(ts.params)
        optimizer = make_optimizer(cfg.ppo)
        opt_state = ts.opt_state
        generator = torch.Generator()
        generator.set_state(ts.rng)
        step = ts.step
        hist = {f: [float(x) for x in np.asarray(ts.history.get(f, ()))]
                for f in HISTORY_FIELDS}
        # a state carried from a reference checkpoint written before the
        # health counters existed has no such columns: zero-pad them to the
        # reward column's length (healthy episodes logged zeros anyway)
        for f in HISTORY_FIELDS:
            if len(hist[f]) < len(hist["reward"]):
                hist[f] += [0.0] * (len(hist["reward"]) - len(hist[f]))
    ep0 = 0 if ts is None else ts.episode
    engine.episode = ep0              # sink episode ids continue, not restart
    watchdog = resolve_watchdog(cfg.watchdog)
    health = {} if health is None else health

    def fill_health() -> Dict[str, Any]:
        health.update(quarantines=int(round(sum(hist["quarantines"]))),
                      grad_skips=int(round(sum(hist["grad_skips"]))),
                      rollbacks=int(_rollbacks),
                      sink_retries=_sink_retries0 + (
                          engine.sink.retries if engine.sink else 0))
        return {k: health[k] for k in HEALTH_FIELDS}

    remaining = cfg.episodes - ep0
    if remaining <= 0:
        fill_health()
        if log_fn:
            log_fn(f"checkpoint already has {ep0} episodes >= target "
                   f"{cfg.episodes}; nothing to train")
        return {k: np.asarray(v) for k, v in hist.items()}, model

    ckpter = None
    if cfg.ckpt_dir:
        ckpter = ckpt_mod.AsyncCheckpointer(
            cfg.ckpt_dir, keep=cfg.ckpt_keep, compress=cfg.ckpt_compress,
            background=cfg.ckpt_async)
    t_ep = [time.perf_counter()]
    ep_hook = on_episode               # the caller's hook

    def on_episode(traj, metrics):
        ep = len(hist["reward"])
        keys = sorted(metrics)
        quar = (torch.zeros_like(traj.reward[0, 0]) if traj.valid is None
                else torch.sum(1.0 - traj.valid))
        # one device-to-host transfer per episode: the history's scalars
        # and the update's metrics together
        vals = torch.stack([torch.mean(torch.sum(traj.reward, dim=1)),
                            torch.mean(traj.cd[:, -10:]),
                            torch.mean(torch.abs(traj.cl[:, -10:])), quar,
                            *(metrics[k] for k in keys)]).tolist()
        r, cd, cl, quar = vals[:4]
        mf = dict(zip(keys, vals[4:]))
        skips = mf.get("grad_skips", 0.0)
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
        if ep_hook is not None:
            ep_hook(traj, metrics)
        if watchdog is not None:
            reason = watchdog.observe(mf, episode=ep)
            if reason is not None:
                # raised BEFORE on_state fires for this episode, so the
                # anomalous state is never checkpointed: the latest
                # checkpoint on disk is by construction a healthy one
                raise DivergenceError(ep, reason)

    def on_state(carry):
        if ckpter is None:
            return
        done = len(hist["reward"])    # episodes completed, incl. resumed
        if done % max(1, cfg.ckpt_every) and done != cfg.episodes:
            return
        snap = TrainState(params=carry.model.state_dict(),
                          opt_state=carry.opt_state,
                          rng=carry.generator.get_state(), step=carry.step,
                          episode=done, env_state=st_b, obs=obs_b,
                          history={f: np.asarray(hist[f])
                                   for f in HISTORY_FIELDS})
        ckpter.save(done, ts_mod.to_tree(snap),
                    metadata=ts_mod.state_metadata(
                        snap, {**run_meta, "health": fill_health()}))

    divergence: Optional[DivergenceError] = None
    try:
        model, _, _ = engine.run_sync(
            model, opt_state, cfg.ppo, optimizer, st_b, obs_b, remaining,
            generator=generator, step=step,
            noise=None if noise is None else noise[ep0:],
            perms=None if perms is None else perms[ep0:],
            on_batch=None if interface is None else interface.exchange,
            on_episode=on_episode, on_state=on_state)
    except DivergenceError as e:
        divergence = e
    finally:
        if ckpter is not None:
            ckpter.close()            # drain the in-flight write
            for k, x in (("ckpt_saves", ckpter.saves),
                         ("ckpt_bytes", ckpter.bytes_written),
                         ("ckpt_time_blocked", ckpter.time_blocked),
                         ("ckpt_time_waited", ckpter.time_waited)):
                health[k] = health.get(k, 0) + x
            if log_fn and ckpter.saves:
                log_fn(f"checkpoints: {ckpter.saves} saves, "
                       f"{ckpter.bytes_written / 1e6:.2f} MB -> "
                       f"{cfg.ckpt_dir} ({ckpter.time_blocked:.3f}s "
                       f"caller-visible)")

    if divergence is not None:
        # roll back to the last healthy checkpoint (the anomalous episode
        # was never saved) and replay; without a ckpt_dir the retry is a
        # fresh restart.  Deterministic divergences replay identically and
        # exhaust the retry budget; the error below says so.
        max_rb = watchdog.cfg.max_rollbacks if watchdog else 0
        if _rollbacks >= max_rb:
            raise RuntimeError(
                f"training diverged and {_rollbacks} rollback(s) to the "
                f"last healthy checkpoint did not clear it ({divergence}); "
                f"a deterministic divergence replays identically: lower "
                f"the learning rate / tighten PPO clipping, or raise "
                f"WatchdogConfig.max_rollbacks if the trigger is transient"
            ) from divergence
        if log_fn:
            log_fn(f"watchdog: {divergence}; rolling back "
                   f"(retry {_rollbacks + 1}/{max_rb})")
        retry_cfg = dataclasses.replace(
            cfg, resume="auto" if cfg.ckpt_dir else None)
        # a cfg-built sink dies with this engine, so its retry count is
        # carried forward; an explicit sink= object survives the recursion
        # and keeps its own count
        prior = (0 if sink is not None
                 else _sink_retries0 + (engine.sink.retries
                                        if engine.sink else 0))
        return train(retry_cfg, log_fn=log_fn, model=init_model,
                     noise=noise, perms=perms, interface=interface,
                     sink=sink, on_episode=ep_hook, health=health,
                     _rollbacks=_rollbacks + 1, _sink_retries0=prior)

    fill_health()
    return {k: np.asarray(v) for k, v in hist.items()}, model
