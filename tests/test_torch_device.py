"""The port's entry points default to the card and never fall back: asked
for CUDA (the default) where none is present, each raises instead of
running on the CPU.  CUDA is hidden with a monkeypatch, so the test runs
the same on a host with a card."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.cfd import grid, scenarios, solver
from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.drl import networks
from repro_torch.drl.engine import EngineConfig, RolloutEngine
from repro_torch.drl.ppo import PPOConfig
from repro_torch.drl.train import TrainConfig, train
from repro_torch.models import model

CFG = grid.GridConfig(res=4)


def _geom():
    return grid.build_geometry(CFG)


def _tree():
    rng = np.random.default_rng(0)
    sizes = [(8, 4), (4, 4), (4, 1)]
    layers = [{"w": rng.standard_normal(s), "b": np.zeros(s[1])}
              for s in sizes]
    return {"actor": layers, "critic": [dict(x) for x in layers],
            "log_std": np.zeros(1)}


ENTRY_POINTS = {
    "solver.init_state": lambda: solver.init_state(CFG, _geom()),
    "solver.geom_to_arrays": lambda: solver.geom_to_arrays(_geom()),
    "scenarios.scenario_params": lambda: scenarios.scenario_params(
        scenarios.get_scenario("cyl_re100"), CFG, cd0=3.0),
    "scenarios.batch_params": lambda: scenarios.batch_params(
        ["cyl_re100"], CFG, cd0s=[3.0]),
    "networks.init_actor_critic": lambda: networks.init_actor_critic(
        networks.PolicyConfig(obs_dim=8, hidden=4),
        torch.Generator().manual_seed(0)),
    "RolloutEngine.init": lambda: RolloutEngine(
        None, EngineConfig(n_envs=1, horizon=1)).init(
        networks.PolicyConfig(obs_dim=8, hidden=4), PPOConfig(), 0),
    "convert.params_from_jax": lambda: convert.params_from_jax(_tree()),
    "convert.flow_state_from_numpy": lambda: convert.flow_state_from_numpy(
        np.zeros((2, 3)), np.zeros((3, 2)), np.zeros((2, 2))),
    "convert.geom_arrays_from_numpy": lambda: convert.geom_arrays_from_numpy(
        [np.zeros(2)] * len(solver.GeomArrays._fields)),
    "CylinderEnv": lambda: CylinderEnv(EnvConfig(grid=CFG)),
    "model.init_params": lambda: model.init_params(
        get_config("rwkv6-3b").reduced()),
    "convert.model_params_from_jax": lambda: convert.model_params_from_jax(
        get_config("rwkv6-3b").reduced(), {}),
    "model.init_cache": lambda: model.init_cache(
        get_config("llama3-405b").reduced(), 1, 4),
    "convert.cache_from_jax": lambda: convert.cache_from_jax(
        get_config("rwkv6-3b").reduced(), {}),
    "train": lambda: train(TrainConfig(env=EnvConfig(grid=CFG)),
                           log_fn=None),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[name]()


def test_resolve_device_cpu_and_unsupported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
