"""Episode rollout: a loop over actuation periods on a batch of envs.

Port of ``repro.drl.rollout`` (where the reference scans one env and vmaps
over N, the port loops over T on batched env state).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


@torch.no_grad()
def rollout_batch(env_step_fn, model, st0_b, obs0_b, length: int, *,
                  generator: Optional[torch.Generator] = None, noise=None,
                  obs_aux_fn=None) -> Tuple[object, Trajectory]:
    """Roll every env of the batch for ``length`` actuation periods.

    ``env_step_fn(state, action) -> (state, EnvOutput)``; ``noise``
    (optional, (N, T, act_dim)) injects the policy's standard-normal draws,
    otherwise they come from ``generator``.  ``obs_aux_fn(state)`` is
    evaluated once on the initial state and fed to every policy call."""
    aux0 = None if obs_aux_fn is None else obs_aux_fn(st0_b)
    st, obs = st0_b, obs0_b
    rows = []
    for t in range(length):
        eps = (None if noise is None else torch.as_tensor(
            noise[:, t], dtype=torch.float32, device=obs.device))
        act, logp = networks.sample_action(model, obs, generator=generator,
                                           eps=eps, aux=aux0)
        # scalar envs take the bare amplitude
        a = act[..., 0] if act.shape[-1] == 1 else act
        st, out = env_step_fn(st, a)
        rows.append((obs, act, logp, out.reward, out.cd, out.cl, out.valid))
        obs = out.obs
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
