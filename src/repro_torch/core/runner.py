"""Distributed multi-env DRL rollout on a plan's mesh.

Port of ``repro.core.runner``.  The paper's two parallel axes map onto
the mesh axes (``launch/mesh.py``):

  n_envs  -> "data"  : the env batch, embarrassingly parallel
  n_ranks -> "model" : spatial domain decomposition of each CFD grid, the
                       x-slabs of ``cfd/decomp.py`` with their halo messages

The collect itself (rollout, values, GAE, flatten) is
``repro_torch.drl.engine.RolloutEngine``; this module is the thin
mesh-facing facade for CFD-only sharded stepping and the placement of a
restored env batch.
"""
from __future__ import annotations

from repro_torch.cfd.env import CylinderEnv
from repro_torch.cfd.solver import FlowState
from repro_torch.drl.engine import (EngineConfig, RolloutEngine,
                                    env_state_specs, place_env_batch,
                                    shard_env_batch)

__all__ = ["env_state_specs", "shard_env_batch", "place_env_batch",
           "make_distributed_collect", "make_sharded_cfd_step",
           "restore_env_batch"]


def restore_env_batch(mesh, host_state, n_ranks: int = 1):
    """Place a checkpoint-restored env batch onto ``mesh``: the cross-plan
    resume primitive, the rules ``shard_env_batch`` applies to a fresh
    batch."""
    return place_env_batch(mesh, host_state, n_ranks)


def make_distributed_collect(env: CylinderEnv, mesh, n_envs: int,
                             length: int, n_ranks: int = 1,
                             gamma: float = 0.99, lam: float = 0.95):
    """``(collect, engine)``: ``collect(model, st_b, obs_b, generator=)
    -> (Batch, Trajectory)`` is the engine's collect of ``length`` actions
    over ``n_envs`` envs on ``mesh``; the engine is returned beside it (the
    reference returns its untraced closure there, for dry-run lowering)."""
    engine = RolloutEngine.for_env(
        env, EngineConfig(n_envs=n_envs, horizon=length, gamma=gamma,
                          lam=lam, n_ranks=n_ranks),
        mesh=mesh)
    return engine.collect, engine


def make_sharded_cfd_step(env: CylinderEnv, mesh):
    """One spatially sharded CFD solver step (the n_ranks axis alone):
    ``step(state, jet) -> (FlowState, StepOutputs)`` with the pressure
    solve split into the mesh's "model" x-slabs (the halo backend at one
    exchange per half-sweep, the monolithic iteration); the state is put
    on the mesh's device first."""
    from repro_torch.cfd import solver

    n_ranks = mesh.shape["model"]

    def step(state: FlowState, jet):
        state = FlowState(*shard_env_batch(mesh, tuple(state)))
        return solver.step(env.cfg.grid, env.geom_arrays, state, jet,
                           backend="halo" if n_ranks > 1 else "reference",
                           mesh=mesh)

    return step
