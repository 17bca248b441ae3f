"""The port's DRL dry run (``launch/dryrun_drl.py``) against the reference's
``tools/dryrun_drl.py``.

The reference's collect is lowered and compiled in a child process on
forced CPU devices (``JAX_PLATFORMS=cpu``) at a small env (res 6, 2 envs,
2 actions, 2 dt an action, 4 SOR pairs) and read by ``hlo_analysis``, as
the reference tool reads its own: on one device, and on the halo backend
over (1, 2) and (1, 4) meshes (the paper's N_ranks); its env states carry
their scenario parameters (``EnvState.scn``), which the tool's abstract
states predate.  The port counts one action and the postprocess on meta
tensors; above one rank its collectives are the halo messages, held
against ``decomp.record_messages()`` in a CPU run of the same collect."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.cfd import decomp
from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.core import autotune as tat
from repro_torch.drl import networks, rollout
from repro_torch.kernels.actuation import ops as aops
from repro_torch.launch import dryrun_drl
from repro_torch.launch.mesh import make_abstract_mesh, mesh_for_plan

SRC = str(Path(__file__).resolve().parent.parent / "src")
N_ENVS, ACTIONS, RES, DT_A, SOR = 2, 2, 6, 2, 4
# the port's flops within 2% of the reference's (measured equal: both count
# the policy's and the value head's products, and no CFD op is a product)
TOL_FLOPS = 0.02
RANKS = (2, 4)

_CHILD = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from repro.cfd import scenarios, solver
from repro.cfd.env import CylinderEnv, EnvConfig, EnvState
from repro.cfd.grid import GridConfig
from repro.core import runner
from repro.drl import networks
from repro.launch import hlo_analysis
N, A = {n}, {a}
out = {{}}
for r in (1,) + {ranks!r}:
  mesh = jax.sharding.Mesh(np.array(jax.devices()[:r]).reshape(1, r),
                           ("data", "model"))
  env = CylinderEnv(EnvConfig(
      grid=GridConfig(res={res}, dt=0.005, poisson_iters={sor}),
      steps_per_action={dt}, actions_per_episode=A, warmup_time=0.0),
      **(dict(backend="halo", mesh=mesh) if r > 1 else {{}}))
  ny, nx = env.cfg.grid.ny, env.cfg.grid.nx
  scn = scenarios.batch_params([env.cfg.scenario()] * N, env.cfg.grid,
                               cd0s=[0.0] * N)
  st_b = jax.eval_shape(lambda: EnvState(
      flow=solver.FlowState(u=jnp.zeros((N, ny, nx + 1), jnp.float32),
                            v=jnp.zeros((N, ny + 1, nx), jnp.float32),
                            p=jnp.zeros((N, ny, nx), jnp.float32)),
      jet_vel=jnp.zeros((N,), jnp.float32), t=jnp.zeros((N,), jnp.int32),
      scn=scn))
  obs_b = jax.ShapeDtypeStruct((N, env.cfg.obs_dim), jnp.float32)
  params = jax.eval_shape(lambda: networks.init_actor_critic(
      networks.PolicyConfig(), jax.random.PRNGKey(0)))
  key = jax.ShapeDtypeStruct((2,), jnp.uint32)
  jitted, _ = runner.make_distributed_collect(env, mesh, N, A, n_ranks=r)
  with mesh:
      txt = jitted.lower(params, st_b, obs_b, key).compile().as_text()
  out[r] = hlo_analysis.analyze(txt)
print(json.dumps(out))
"""


def small_env() -> EnvConfig:
    return EnvConfig(grid=GridConfig(res=RES, dt=0.005, poisson_iters=SOR),
                     steps_per_action=DT_A, actions_per_episode=ACTIONS,
                     warmup_time=0.0)


def port_counts(backend, n_ranks=1):
    return dryrun_drl.count_collect(
        small_env(), N_ENVS, ACTIONS, backend=backend, n_ranks=n_ranks,
        mesh=make_abstract_mesh((1, n_ranks), ("data", "model")))


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's ``hlo_analysis`` of its collect by rank count."""
    d = tmp_path_factory.mktemp("dryrun_drl")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count="
                        f"{max(RANKS)}",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    code = textwrap.dedent(_CHILD.format(n=N_ENVS, a=ACTIONS, res=RES,
                                         sor=SOR, dt=DT_A, ranks=RANKS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return {int(k): v for k, v in json.loads(
        out.stdout.strip().splitlines()[-1]).items()}


@pytest.fixture
def reference_hlo(reference_runs):
    return reference_runs[1]


def test_collect_flops_match_the_reference(reference_hlo):
    """One action times the actions plus the postprocess, on the reference
    solver: within 2% of the reference's scaled scan, and no collective
    at one rank."""
    got = port_counts("reference")["cost"]
    want = reference_hlo["flops"]
    print(f"[cost] DRL collect: flops port {got['flops']} reference {want}; "
          f"bytes port {got['bytes']} reference {reference_hlo['bytes']} "
          f"(ratio {got['bytes'] / reference_hlo['bytes']:.4f})")
    assert abs(got["flops"] - want) <= TOL_FLOPS * want, (got, want)
    assert got["coll_bytes"] == reference_hlo["coll_bytes"] == 0


def test_fused_backend_counts_the_kernel_by_its_work():
    """``backend="fused"``: one ``fused_interval`` entry an action, each the
    kernel's ``work(...)`` at the env's shape; the policy's products as on
    the reference backend."""
    fused, ref = port_counts("fused")["cost"], port_counts("reference")[
        "cost"]
    flops, nbytes = aops.work(small_env().grid, N_ENVS, DT_A)
    assert fused["kernels"] == {"fused_interval": {
        "launches": ACTIONS, "flops": ACTIONS * flops,
        "bytes": ACTIONS * nbytes}}
    assert fused["flops"] == ref["flops"] + ACTIONS * flops


def test_dryrun_drl_writes_its_record(tmp_path):
    """``python -m repro_torch.launch.dryrun_drl --n-envs 8 --res 6
    --actions 4``: the reference tool's fields, priced against
    ``h100_sxm``."""
    out = tmp_path / "drl.json"
    dryrun_drl.main(["--n-envs", "8", "--res", "6", "--actions", "4",
                     "--out", str(out)])
    rec = json.loads(out.read_text())
    assert (rec["n_envs"], rec["n_ranks"], rec["actions"]) == (8, 1, 4)
    assert rec["grid"] == [26, 132] and rec["hw"]["name"] == "h100_sxm"
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["peak_per_device_bytes"] > 0
    assert set(rec["terms_s"]) == {"compute", "memory", "collective"}
    assert rec["terms_s"]["memory"] == (rec["cost_analysis"]["bytes"]
                                        / rec["hw"]["hbm_bw"])


def _messages_of_a_cpu_collect(n_ranks):
    """Bytes of every halo message ``decomp.record_messages()`` sees in a
    CPU run of the same collect (``ACTIONS`` actions of ``N_ENVS`` envs on
    the halo backend over ``mesh_for_plan((1, n_ranks))``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tat.FORCE_DEVICE_COUNT, str(n_ranks))
        mesh = mesh_for_plan((1, n_ranks), device="cpu")
        env = CylinderEnv(small_env(), backend="halo", mesh=mesh,
                          device="cpu")
        st_b, obs_b = env.reset_batch(("cyl_re100",) * N_ENVS, N_ENVS)
        model = networks.init_actor_critic(
            networks.PolicyConfig(obs_dim=env.cfg.obs_dim,
                                  act_dim=env.cfg.act_dim),
            torch.Generator().manual_seed(0), device="cpu")
        with decomp.record_messages() as log, torch.no_grad():
            rollout.rollout_batch(env.env_step, model, st_b, obs_b, ACTIONS,
                                  generator=torch.Generator().manual_seed(1),
                                  obs_aux_fn=env.obs_aux)
    assert log
    return N_ENVS * sum(count * h * w * 4 for (h, w), count in log)


@pytest.mark.parametrize("n_ranks", RANKS)
def test_more_ranks_count_the_halo_messages(reference_runs, n_ranks):
    """n_ranks 2 and 4 on the halo backend (the one run there): flops
    within 2% of the reference's halo collect, and the collective bytes
    are the halo messages, one ``collective-permute`` an exchange, equal
    to what ``decomp.record_messages()`` sees in a CPU run of the same
    collect."""
    got = dryrun_drl.count_collect(
        small_env(), N_ENVS, ACTIONS, n_ranks=n_ranks,
        mesh=make_abstract_mesh((1, n_ranks), ("data", "model")))["cost"]
    want = reference_runs[n_ranks]
    print(f"[cost] DRL collect at n_ranks {n_ranks}: flops port "
          f"{got['flops']} reference {want['flops']}; collectives per "
          f"device port {got['coll_bytes'] / n_ranks} reference "
          f"{want['coll_bytes']} ("
          + ", ".join(f"{k} {v}" for k, v in sorted(want.items())
                      if k.startswith("coll_") and k != "coll_bytes")
          + ")")
    assert abs(got["flops"] - want["flops"]) <= TOL_FLOPS * want["flops"]
    sent = _messages_of_a_cpu_collect(n_ranks)
    assert got["coll_collective-permute"] == sent > 0
    assert got["coll_bytes"] == sent


def test_more_ranks_refuse_a_single_rank_backend():
    with pytest.raises(ValueError, match="halo"):
        dryrun_drl.count_collect(small_env(), 2, 1, n_ranks=2,
                                 backend="fused")


def test_dryrun_drl_writes_a_halo_record(tmp_path):
    """``--n-ranks 4``: the record states the halo backend and its
    collective-permute bytes, split over "data" x n_ranks."""
    out = tmp_path / "drl.json"
    dryrun_drl.main(["--n-envs", "16", "--res", "6", "--actions", "1",
                     "--n-ranks", "4", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["backend"] == "halo" and rec["n_ranks"] == 4
    cost = rec["cost_analysis"]
    assert cost["coll_collective-permute"] > 0
    assert cost["coll_bytes"] == cost["coll_collective-permute"]
    assert "halo messages" in rec["per_device"]
    assert rec["terms_s"]["collective"] == (cost["coll_bytes"]
                                            / rec["hw"]["ici_bw"])
