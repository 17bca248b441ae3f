"""The system under test, set up as ``repro_torch.drl.train.train`` sets it
up, and the inputs the benchmark makes for it from ``--seed``.

Everything that touches the program lives here: the env batch
(``CylinderEnv``, ``reset_batch``: the uncontrolled warmup and the C_D0
calibration), the engine (``RolloutEngine.for_env``, ``engine.init``), one
episode a call of ``RolloutEngine.run_sync``, and the program's counters.
The policy's weights, the rollout noise and the PPO permutations are the
benchmark's, drawn on the device from the seed and handed to the program
(``run_sync``'s ``noise`` / ``perms``), so the reference gets the same.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from afcbench.reference import ppo as ref_ppo


def weights(obs_dim: int, act_dim: int, hidden: int, depth: int,
            init_log_std: float, seed: int, device) -> Dict[str, torch.Tensor]:
    """The policy's parameters from the seed, on the device: every weight
    matrix from one normal draw clipped to two standard deviations and
    scaled by 1/sqrt(fan_in) (a truncated fan-in initialisation), biases
    zero, the log-std at ``init_log_std``.  Named as the program's
    ``state_dict`` names them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes = {}
    for net, out in (("actor", act_dim), ("critic", 1)):
        sizes = [obs_dim] + [hidden] * depth + [out]
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes[f"{net}.{i}.weight"] = (b, a)
    total = sum(a * b for a, b in shapes.values())
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    params, at = {}, 0
    for name in ref_ppo.layer_names(depth)[:-1]:
        if name.endswith(".weight"):
            b, a = shapes[name]
            params[name] = flat[at:at + a * b].view(b, a) / math.sqrt(a)
            at += a * b
            last = b
        else:
            params[name] = torch.zeros(last, device=device)
    params["log_std"] = torch.full((act_dim,), float(init_log_std),
                                   device=device)
    return params


class Inputs:
    """Each episode's rollout noise (N, T, A) and the update's epoch
    permutations (epochs, N T), drawn in turn from one device generator
    seeded with the run's seed."""

    def __init__(self, seed: int, n_envs: int, horizon: int, act_dim: int,
                 epochs: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.shape = (n_envs, horizon, act_dim)
        self.epochs, self.device = epochs, device

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        noise = torch.randn(self.shape, generator=self.gen,
                            device=self.device)
        n = self.shape[0] * self.shape[1]
        keys = torch.rand((self.epochs, n), generator=self.gen,
                          device=self.device)
        return noise, torch.argsort(keys, dim=1)


def sample_intervals(seed: int, episodes: int, horizon: int,
                     per_episode: int) -> List[Tuple[int, int]]:
    """The (episode, action) intervals the reference recomputes, drawn
    from the seed: ``per_episode`` distinct actions of each episode."""
    rng = np.random.default_rng(seed)
    return [(e, int(t)) for e in range(episodes)
            for t in sorted(rng.choice(horizon, per_episode, replace=False))]


class Recorder:
    """Wraps the env step during the first episodes: at the sampled
    intervals it keeps the state the step started from, the action, and
    what the step produced (the program's own tensors, cloned)."""

    def __init__(self, step_fn, horizon: int, wanted):
        self.step_fn, self.horizon = step_fn, horizon
        self.wanted = set(wanted)
        self.calls = 0
        self.records: Dict[Tuple[int, int], dict] = {}

    def __call__(self, st, action):
        key = divmod(self.calls, self.horizon)
        self.calls += 1
        if key not in self.wanted:
            return self.step_fn(st, action)
        pre = {"u": st.flow.u.clone(), "v": st.flow.v.clone(),
               "p": st.flow.p.clone(), "amp": st.jet_vel.clone(),
               "action": torch.as_tensor(action).clone(),
               "cd0": st.scn.cd0.clone()}
        st2, out = self.step_fn(st, action)
        self.records[key] = {
            "pre": pre,
            "post": {"u": st2.flow.u.clone(), "v": st2.flow.v.clone(),
                     "p": st2.flow.p.clone(), "amp": st2.jet_vel.clone(),
                     "obs": out.obs.clone(), "reward": out.reward.clone(),
                     "cd": out.cd.clone(), "cl": out.cl.clone()}}
        return st2, out


class OptimizerRecorder:
    """Wraps the optimizer during the first episodes: for its first
    ``calls`` calls it keeps the parameters it is handed and the gradients
    as it gets them (clones)."""

    def __init__(self, optimizer, names: List[str], calls: int):
        self.optimizer, self.names, self.calls = optimizer, names, calls
        self.steps: List[dict] = []
        self.wrapped = type(optimizer)(optimizer.init, self.update)

    def update(self, grads, state, params, step, *a, **kw):
        if len(self.steps) < self.calls:
            def named(xs):
                return {k: x.detach().clone() for k, x in zip(self.names, xs)}
            self.steps.append({"params": named(params),
                               "grads": named(grads)})
        return self.optimizer.update(grads, state, params, step, *a, **kw)


@contextlib.contextmanager
def recording_losses(calls: int):
    """While entered, the PPO loss of the update's first ``calls``
    minibatches is kept (detached clones) in the list yielded."""
    from repro_torch.drl import ppo
    losses: List[torch.Tensor] = []
    real = ppo.ppo_loss

    def ppo_loss(cfg, model, batch):
        out = real(cfg, model, batch)
        if len(losses) < calls:
            losses.append(out[0].detach().clone())
        return out
    ppo.ppo_loss = ppo_loss
    try:
        yield losses
    finally:
        ppo.ppo_loss = real


@dataclass
class Episode:
    """What one call of ``run_sync`` handed back: the trajectory and the
    update's metrics."""
    traj: object
    metrics: Dict[str, torch.Tensor]


@dataclass
class Program:
    """The env batch, the engine, the model and its optimizer state."""
    env: object
    engine: object
    model: torch.nn.Module
    optimizer: object
    opt_state: dict
    ppo_cfg: object
    st_b: object
    obs_b: torch.Tensor
    obs_dim: int
    act_dim: int
    step: int = 0

    def episode(self, noise, perms) -> Episode:
        """One episode through ``run_sync``: collect, postprocess, update;
        returns after the update's metrics reached the host."""
        got = {}

        def on_episode(traj, metrics):
            got["traj"], got["metrics"] = traj, metrics

        def on_state(carry):
            got["step"] = carry.step

        self.model, self.opt_state, _ = self.engine.run_sync(
            self.model, self.opt_state, self.ppo_cfg, self.optimizer,
            self.st_b, self.obs_b, 1, step=self.step, noise=[noise],
            perms=[perms], on_episode=on_episode, on_state=on_state)
        self.step = got["step"]
        return Episode(got["traj"], got["metrics"])


def env_config(config: dict, traffic: dict):
    """The program's ``EnvConfig`` and ``PPOConfig`` of a cell."""
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.drl.ppo import PPOConfig
    e = config["env"]
    grid = GridConfig(res=int(traffic["res"]), re=float(e["re"]),
                      dt=float(e["dt"]), poisson_iters=int(e["poisson_iters"]),
                      poisson_omega=float(e["poisson_omega"]))
    env = EnvConfig(grid=grid, steps_per_action=int(e["steps_per_action"]),
                    actions_per_episode=int(e["actions_per_episode"]),
                    beta=float(e["beta"]), reward_omega=float(e["reward_omega"]),
                    warmup_time=float(e["warmup_time"]))
    ppo = PPOConfig(**{k: v for k, v in config["ppo"].items()})
    return env, ppo


def scenarios(config: dict, traffic: dict) -> Tuple[str, ...]:
    """The scenario of each slot of the batch's round-robin: the mix's own
    list, or the configuration's scenario."""
    return tuple(traffic.get("scenarios") or [config["scenario"]])


def build_env(config: dict, traffic: dict, device):
    """The env batch as ``train()`` builds it: ``CylinderEnv`` on the
    mix's backend, ``reset_batch`` (the warmup and the C_D0 calibration)."""
    from repro_torch.cfd.env import CylinderEnv
    env_cfg, _ = env_config(config, traffic)
    env = CylinderEnv(env_cfg, backend=traffic["backend"], device=device)
    st_b, obs_b = env.reset_batch(scenarios(config, traffic),
                                  int(traffic["n_envs"]))
    return env, st_b, obs_b


def build_program(env, st_b, obs_b, config: dict, traffic: dict, seed: int,
                  device, timing: bool = False) -> Program:
    """The engine and a fresh model for one run (``engine.init``), the
    model's parameters replaced by the benchmark's from the seed."""
    from repro_torch.drl import networks
    from repro_torch.drl.engine import EngineConfig, RolloutEngine
    if traffic.get("engine", "sync") != "sync":
        raise ValueError(f"engine {traffic['engine']!r}: this harness drives "
                         f"run_sync")
    _, ppo_cfg = env_config(config, traffic)
    pol = config["policy"]
    obs_dim = int(obs_b.shape[-1])
    jv = st_b.jet_vel
    act_dim = int(jv.shape[-1]) if jv.dim() > 1 else 1
    pcfg = networks.PolicyConfig(obs_dim=obs_dim, act_dim=act_dim,
                                 hidden=int(pol["hidden"]),
                                 depth=int(pol["depth"]),
                                 init_log_std=float(pol["init_log_std"]),
                                 policy=traffic.get("policy", "mlp"))
    engine = RolloutEngine.for_env(
        env, EngineConfig(n_envs=int(traffic["n_envs"]),
                          horizon=env.cfg.actions_per_episode,
                          gamma=ppo_cfg.gamma, lam=ppo_cfg.lam,
                          timing=timing))
    model, optimizer, opt_state, _ = engine.init(pcfg, ppo_cfg, seed, device)
    w = weights(obs_dim, act_dim, pcfg.hidden, pcfg.depth, pcfg.init_log_std,
                seed, device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(w[name])
    return Program(env=env, engine=engine, model=model, optimizer=optimizer,
                   opt_state=opt_state, ppo_cfg=ppo_cfg, st_b=st_b,
                   obs_b=obs_b, obs_dim=obs_dim, act_dim=act_dim)


def unbuilt_kernels() -> List[str]:
    """The program's kernel libraries not yet built in this checkout."""
    from repro_torch.kernels import build
    return [n for n in build.SOURCES if not build.library_path(n).exists()]


def kernels_built(unbuilt: List[str]) -> List[str]:
    """Of ``unbuilt``, the libraries built since: a run whose set-up
    compiled."""
    from repro_torch.kernels import build
    return [n for n in unbuilt if build.library_path(n).exists()]


def kernel_counters() -> Dict[str, int]:
    """The fused interval's launch counters, by tier."""
    from repro_torch.kernels.actuation import ops
    f = ops.fused_interval_cuda
    return {"launches": f.launches, "per_body": f.launches_per_body,
            "resident": f.launches_resident, "global": f.launches_global}


def params_of(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.named_parameters()}
