"""The benchmark's frozen yardstick: operation and byte counts of the
fused actuation interval and of the policy network, and the card's
published peaks.

A copy, not an import, of ``repro_torch.kernels.actuation.ops.work`` and
``repro_torch.kernels.poisson.ops.FLOP_SOR_POINT``: the counts every
roofline share and ``step_mfu_pct`` divide by stay as they are when the
program changes.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # bfloat16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12       # HBM3 bytes a second

# float32 operations per point of the fused interval, counted from the
# kernel's source (csrc/fused_interval.cu) when the count was frozen
FLOP_SOR_POINT = 10            # one point of a red-black SOR half-sweep pair
FLOP_MOMENTUM_POINT = 51       # predictor + penalization + force, per face
FLOP_RHS_POINT = 6             # divergence / dt
FLOP_CORRECT_POINT = 4         # projection correction, per face
FLOP_BODY_POINT = 4            # per face and body, per-body instantiation


def interval_work(ny: int, nx: int, poisson_iters: int, n_env: int,
                  n_steps: int, n_bodies: int = 0, n_geoms: int = 1):
    """(float32 operations, bytes) of one fused interval of ``n_env`` envs
    on an (ny, nx) grid: every input read once (the fields, the geometry of
    each of ``n_geoms`` geometries, the per-env scalars) and every output
    written once.  ``n_bodies`` > 0 is the per-body instantiation."""
    nu, nv, npts = ny * (nx + 1), (ny + 1) * nx, ny * nx
    flops = n_env * n_steps * (
        poisson_iters * npts * FLOP_SOR_POINT
        + (nu + nv) * (FLOP_MOMENTUM_POINT + FLOP_BODY_POINT * n_bodies)
        + npts * FLOP_RHS_POINT + (nu + nv) * FLOP_CORRECT_POINT)
    if not n_bodies:
        return flops, 4 * (2 * n_env * (nu + nv + npts) + 6 * nu + 6 * nv
                           + ny + 3 * n_env + 2 * n_env * n_steps)
    planes = 5 + 2 * n_bodies     # chi, 2 jet, jmask, rmask, rotb, own
    return flops, 4 * (2 * n_env * (nu + nv + npts)
                       + n_geoms * (planes * (nu + nv) + ny)
                       + n_env * (n_bodies + 3)
                       + 2 * n_env * n_steps * n_bodies)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the float32 peak
    or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def mlp_forward_flops(sizes, rows: int) -> int:
    """Operations of one forward pass of a dense stack of ``sizes`` over
    ``rows`` inputs: a multiply and an add per weight, an add per bias,
    and one tanh (counted as one operation) per hidden unit."""
    flops = 0
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        flops += rows * (2 * a * b + b)
        if i < len(sizes) - 2:
            flops += rows * b
    return flops


def policy_flops(obs_dim: int, act_dim: int, hidden: int, depth: int,
                 n_envs: int, horizon: int, epochs: int) -> int:
    """Operations of the 2x512 tanh actor-critic in one PPO episode:
    the actor's forward for every action of the collect, the critic's over
    the episode and its last observation, and per epoch a forward of both
    over the whole batch plus a backward of twice a forward's operations
    (the gradients of the inputs and of the weights)."""
    actor = [obs_dim] + [hidden] * depth + [act_dim]
    critic = [obs_dim] + [hidden] * depth + [1]
    rows = n_envs * horizon
    collect = mlp_forward_flops(actor, rows)
    values = mlp_forward_flops(critic, rows + n_envs)
    update = epochs * 3 * (mlp_forward_flops(actor, rows)
                           + mlp_forward_flops(critic, rows))
    return collect + values + update
