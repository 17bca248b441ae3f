"""Episode rollout: a loop over actuation periods on a batch of envs.

Port of ``repro.drl.rollout`` (where the reference scans one env and vmaps
over N, the port loops over T on batched env state).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.drl import networks


class Trajectory(NamedTuple):
    """Per-env episode arrays with a leading env dim N."""
    obs: torch.Tensor      # (N, T, obs_dim)
    act: torch.Tensor      # (N, T, act_dim)
    logp: torch.Tensor     # (N, T)
    reward: torch.Tensor   # (N, T)
    cd: torch.Tensor       # (N, T)
    cl: torch.Tensor       # (N, T)
    last_obs: torch.Tensor  # (N, obs_dim)
    probe_xy: torch.Tensor = None    # (N, obs_dim, 2) normalized coords
    probe_mask: torch.Tensor = None  # (N, obs_dim) 1 = live probe slot
    valid: torch.Tensor = None       # (N, T) 1 = healthy step (sentinel)


def _policy(model, obs, generator, eps, aux, per_env: bool):
    """``sample_action`` on the whole batch, or on a fresh copy of each
    env's row, one call an env."""
    if not per_env:
        return networks.sample_action(model, obs, generator=generator,
                                      eps=eps, aux=aux)

    def row(x, i):
        return x[i:i + 1].clone()

    outs = [networks.sample_action(
        model, row(obs, i), eps=row(eps, i),
        aux=None if aux is None else {k: row(v, i) for k, v in aux.items()})
        for i in range(obs.shape[0])]
    return (torch.cat([a for a, _ in outs]), torch.cat([lp for _, lp in outs]))


@torch.no_grad()
def rollout_batch(env_step_fn, model, st0_b, obs0_b, length: int, *,
                  generator: Optional[torch.Generator] = None, noise=None,
                  obs_aux_fn=None, on_action: Optional[Callable] = None,
                  per_env: bool = False
                  ) -> Tuple[object, Trajectory]:
    """Roll every env of the batch for ``length`` actuation periods.

    ``env_step_fn(state, action) -> (state, EnvOutput)``; ``noise``
    (optional, (N, T, act_dim)) injects the policy's standard-normal draws,
    otherwise they come from ``generator``.  ``obs_aux_fn(state)`` is
    evaluated once on the initial state and fed to every policy call.
    ``on_action(t)`` runs after action ``t``'s env step has been issued
    (``RolloutEngine.run_async`` issues update work there).

    ``per_env`` evaluates the policy one env at a time, on a fresh copy of
    its row (the fleet engine's rollout), so an env's action does not
    depend on how many envs the batch holds: a matmul's float32 result
    depends on its row count and alignment.  It needs ``noise``."""
    if per_env and noise is None:
        raise ValueError("rollout_batch(per_env=True) needs injected noise")
    aux0 = None if obs_aux_fn is None else obs_aux_fn(st0_b)
    st, obs = st0_b, obs0_b
    rows = []
    for t in range(length):
        eps = (None if noise is None else torch.as_tensor(
            noise[:, t], dtype=torch.float32, device=obs.device))
        act, logp = _policy(model, obs, generator, eps, aux0, per_env)
        # scalar envs take the bare amplitude
        a = act[..., 0] if act.shape[-1] == 1 else act
        st, out = env_step_fn(st, a)
        rows.append((obs, act, logp, out.reward, out.cd, out.cl, out.valid))
        obs = out.obs
        if on_action is not None:
            on_action(t)
    cols = list(zip(*rows))

    def stack(xs):
        return None if xs[0] is None else torch.stack(xs, dim=1)

    traj = Trajectory(obs=stack(cols[0]), act=stack(cols[1]),
                      logp=stack(cols[2]), reward=stack(cols[3]),
                      cd=stack(cols[4]), cl=stack(cols[5]), last_obs=obs,
                      valid=stack(cols[6]))
    if aux0 is not None:
        traj = traj._replace(probe_xy=aux0["xy"], probe_mask=aux0["mask"])
    return st, traj
