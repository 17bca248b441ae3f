"""The paper's own DRL x CFD workload priced without a device:
``python -m repro_torch.launch.dryrun_drl``.

Twin of the reference's ``tools/dryrun_drl.py``, with its flags (``--n-envs
256 --n-ranks 1 --actions 100 --res 16``) and its record's fields
(``n_envs``, ``n_ranks``, ``grid``, ``actions``, ``peak_per_device_bytes``,
the cost terms under ``cost_analysis`` where the reference writes ``hlo``,
``terms_s``).  The collect is ``core/runner.make_distributed_collect``'s
on the production mesh (the env batch over "data"), from abstract env
states on the meta device (no warmup), the grid at 0.005 dt, 60 SOR pairs
a dt and 50 dt an action, as the reference tool's.

``launch/cost_analysis.CostCounter`` counts one action (the policy call
and ``env_step``) and multiplies it by ``--actions``, as the reference's
analyzer scales the rollout scan by its trip count, and adds the
postprocess (values, GAE, flatten) once, over the whole episode.  The
counts are global; a device's share is the count over the devices the
work is split over, "data" x ``n_ranks`` (the reference's mesh
replicates the rest).  ``terms_s`` prices them against ``h100_sxm``, the
port's card, not the reference's hard-coded TPU rates.  ``--backend``
picks the solver: ``reference`` (the reference tool's, and the one
comparable with it) or ``fused``, whose interval is the fused kernel's
``work(...)``, at one rank; above one rank the solver is ``halo``, and
``--backend fused`` is refused.

``--n-ranks`` above 1 (the paper's N_ranks, and the hybrid N_envs x
N_ranks plans) decomposes each grid into that many x-slabs over "model"
with the halo backend (``cfd/decomp.py``), the one ``train(plan=...)``
runs for a multi-rank plan, on a ("data", "model") mesh of the production
mesh's "data" size by ``n_ranks``.  Every halo exchange counts as one
``collective-permute`` of the bytes its slabs send (``decomp.send``):
those are the record's collectives.  The reference's partitioner also
adds gathers, reductions and all-to-alls for the grid it shards in its
momentum, probes and forces; the port's program has no counterpart of
those (it computes them on whole grids), so they are not counted.

The peak holds the arguments (policy, env states, observations), the
trajectory the episode keeps, and the larger of one action's and the
postprocess's live sets.

    python -m repro_torch.launch.dryrun_drl [--n-envs 256] [--actions 100]
        [--n-ranks 16]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from repro_torch.cfd import scenarios as scn_mod
from repro_torch.cfd import solver
from repro_torch.cfd.env import CylinderEnv, EnvConfig, EnvState
from repro_torch.cfd.grid import GridConfig
from repro_torch.core import runner
from repro_torch.drl import networks, rollout
from repro_torch.launch import cost_analysis, roofline
from repro_torch.launch.dryrun import HW
from repro_torch.launch.mesh import (AXES, make_abstract_mesh,
                                     make_production_mesh)

DEFAULT_OUT = "build/dryrun_drl.json"


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    return type(x)(*(None if v is None else _to_meta(v) for v in x))


def meta_env(cfg: EnvConfig, backend: str, mesh=None) -> CylinderEnv:
    """``cfg``'s env with its geometry on the meta device: its steps run on
    meta env states (the halo backend's slabs over ``mesh``, an
    ``AbstractMesh``)."""
    env = CylinderEnv(cfg, backend=backend, device="cpu",
                      mesh=mesh if backend == "halo" else None)
    env.geom_arrays = _to_meta(env.geom_arrays)
    env.device = torch.device("meta")
    return env


def abstract_batch(env: CylinderEnv, n: int):
    """(env states, observations) of ``n`` envs of ``env``'s scenario as
    meta tensors: the fields of a developed flow, no warmup run."""
    g = env.cfg.grid
    scn = env.cfg.scenario()
    params = scn_mod.batch_params([scn] * n, g, cd0s=[0.0] * n,
                                  device="cpu")
    flow = solver.FlowState(_meta((n, g.ny, g.nx + 1)),
                            _meta((n, g.ny + 1, g.nx)),
                            _meta((n, g.ny, g.nx)))
    a_dim = scn.act_dim
    st = EnvState(flow=flow,
                  jet_vel=_meta((n,) if a_dim == 1 else (n, a_dim)),
                  t=_meta((n,), torch.int64), scn=_to_meta(params))
    return st, _meta((n, env.cfg.obs_dim))


def abstract_trajectory(n: int, T: int, obs_dim: int, act_dim: int,
                        aux) -> rollout.Trajectory:
    """An episode of ``T`` actions of ``n`` envs as meta tensors."""
    return rollout.Trajectory(
        obs=_meta((n, T, obs_dim)), act=_meta((n, T, act_dim)),
        logp=_meta((n, T)), reward=_meta((n, T)), cd=_meta((n, T)),
        cl=_meta((n, T)), last_obs=_meta((n, obs_dim)),
        probe_xy=aux["xy"], probe_mask=aux["mask"])


def _sum(a: dict, b: dict, k: float = 1.0) -> dict:
    """``a + k b`` over the numbers of two nested count dicts."""
    out = dict(a)
    for key, v in b.items():
        out[key] = (_sum(a.get(key, {}), v, k) if isinstance(v, dict)
                    else a.get(key, 0) + k * v)
    return out


def collect_mesh(n_ranks: int):
    """The production mesh, or above one rank its "data" axis by
    ``n_ranks`` on "model" (an env's x-slabs)."""
    mesh = make_production_mesh()
    if n_ranks == 1 or mesh.shape["model"] == n_ranks:
        return mesh
    return make_abstract_mesh((mesh.shape["data"], n_ranks), AXES)


def count_collect(cfg: EnvConfig, n_envs: int, actions: int, *,
                  n_ranks: int = 1, backend: str = "reference",
                  mesh=None) -> dict:
    """The global counts of one collect of ``actions`` actions over
    ``n_envs`` envs of ``cfg``: ``cost`` (the cost-analysis dict: one
    action times ``actions`` plus the postprocess) and ``memory``
    (``argument_bytes``, ``trajectory_bytes``, ``action_bytes`` and
    ``postprocess_bytes``, the largest live set of each, and their
    ``peak_bytes``).  Above one rank the grid is cut into ``n_ranks``
    x-slabs over ``mesh``'s "model" axis (:func:`collect_mesh` by
    default), on the halo backend (what ``train(plan=...)`` runs there)
    in ``backend``'s place; the single-rank "fused" is refused there."""
    if n_ranks > 1:
        if backend != "reference":
            raise ValueError(
                f"n_ranks={n_ranks} decomposes each grid over 'model' with "
                f"the halo backend; {backend!r} runs on one rank")
        backend = "halo"
    mesh = mesh if mesh is not None else collect_mesh(n_ranks)
    if n_ranks > 1 and mesh.shape["model"] != n_ranks:
        raise ValueError(f"n_ranks={n_ranks} does not match the mesh's "
                         f"'model' axis {mesh.shape['model']}")
    env = meta_env(cfg, backend, mesh)
    _, engine = runner.make_distributed_collect(env, mesh, n_envs, actions,
                                                n_ranks=n_ranks)
    pcfg = networks.PolicyConfig(obs_dim=cfg.obs_dim, act_dim=cfg.act_dim)
    model = networks.init_actor_critic(pcfg, torch.Generator().manual_seed(0),
                                       device="cpu").to("meta")
    st_b, obs_b = abstract_batch(env, n_envs)
    noise = _meta((n_envs, 1, cfg.act_dim))
    act_cost, act_mem = cost_analysis.count(
        rollout.rollout_batch, env.env_step, model, st_b, obs_b, 1,
        noise=noise, obs_aux_fn=env.obs_aux)
    traj = abstract_trajectory(n_envs, actions, cfg.obs_dim, cfg.act_dim,
                               env.obs_aux(st_b))
    post_cost, post_mem = cost_analysis.count(engine.postprocess, model,
                                              traj)
    args = cost_analysis.tree_bytes((list(model.parameters()), st_b, obs_b))
    traj_bytes = cost_analysis.tree_bytes(traj)
    live = {"action_bytes": act_mem["peak_per_device_bytes"]
            - act_mem["argument_bytes"],
            "postprocess_bytes": post_mem["peak_per_device_bytes"]
            - post_mem["argument_bytes"]}
    cost = _sum(_sum({}, act_cost, actions), post_cost)
    return {"cost": cost,
            "memory": {"argument_bytes": args,
                       "trajectory_bytes": traj_bytes, **live,
                       "peak_bytes": args + traj_bytes + max(live.values())}}


def run(n_envs: int = 256, n_ranks: int = 1, actions: int = 100,
        res: int = 16, backend: str = "reference",
        out: str = DEFAULT_OUT) -> dict:
    """The reference tool's record for the port's collect, written to
    ``out``."""
    cfg = EnvConfig(grid=GridConfig(res=res, dt=0.005, poisson_iters=60),
                    steps_per_action=50, actions_per_episode=actions,
                    warmup_time=0.0)
    mesh = collect_mesh(n_ranks)
    t0 = time.time()
    counts = count_collect(cfg, n_envs, actions, n_ranks=n_ranks,
                           backend=backend, mesh=mesh)
    shards = mesh.shape["data"] * n_ranks
    per = cost_analysis.per_device(counts, shards)
    cost = per["cost"]
    hw = roofline.hardware_spec(HW)
    rec = {
        "n_envs": n_envs, "n_ranks": n_ranks,
        "grid": [cfg.grid.ny, cfg.grid.nx], "actions": actions,
        "backend": "halo" if n_ranks > 1 else backend, "count_s": time.time() - t0,
        "peak_per_device_bytes": per["memory"]["peak_bytes"],
        "memory_per_device": per["memory"],
        "cost_analysis": cost,
        "per_device": f"the global count split evenly over {shards} "
                      f"devices: 'data' x n_ranks of the production mesh; "
                      f"collectives: the decomposed solve's halo messages "
                      f"(collective-permute), none at one rank; the "
                      f"collectives XLA adds to the reference for its "
                      f"sharded momentum, probes and forces have no "
                      f"counterpart in the port's program",
        "terms_s": {"compute": cost["flops"] / hw.peak_flops,
                    "memory": cost["bytes"] / hw.hbm_bw,
                    "collective": cost["coll_bytes"] / hw.ici_bw},
        "hw": hw.to_dict(),
    }
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    Path(out).write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-envs", type=int, default=256)
    ap.add_argument("--n-ranks", type=int, default=1)
    ap.add_argument("--actions", type=int, default=100)
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--backend", choices=("reference", "fused"),
                    default="reference",
                    help="the solver at one rank; above it, halo")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = run(args.n_envs, args.n_ranks, args.actions, args.res,
              args.backend, args.out)
    print(json.dumps(rec["terms_s"], indent=1))
    print(f"peak/dev {rec['peak_per_device_bytes'] / 2**20:.1f} MiB  "
          f"count {rec['count_s']:.1f}s -> {args.out}")


if __name__ == "__main__":
    main()
