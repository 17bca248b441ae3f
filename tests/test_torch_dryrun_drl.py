"""The port's DRL dry run (``launch/dryrun_drl.py``) against the reference's
``tools/dryrun_drl.py``.

The reference's collect is lowered and compiled in a child process on one
forced CPU device (``JAX_PLATFORMS=cpu``) at a small env (res 6, 2 envs,
2 actions, 2 dt an action, 4 SOR pairs) and read by ``hlo_analysis``, as
the reference tool reads its own; its env states carry their scenario
parameters (``EnvState.scn``), which the tool's abstract states predate.
The port counts one action and the postprocess on meta tensors."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.cfd.env import EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.kernels.actuation import ops as aops
from repro_torch.launch import dryrun_drl
from repro_torch.launch.mesh import make_abstract_mesh

SRC = str(Path(__file__).resolve().parent.parent / "src")
N_ENVS, ACTIONS, RES, DT_A, SOR = 2, 2, 6, 2, 4
# the port's flops within 2% of the reference's (measured equal: both count
# the policy's and the value head's products, and no CFD op is a product)
TOL_FLOPS = 0.02

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
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
env = CylinderEnv(EnvConfig(
    grid=GridConfig(res={res}, dt=0.005, poisson_iters={sor}),
    steps_per_action={dt}, actions_per_episode=A, warmup_time=0.0))
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
jitted, _ = runner.make_distributed_collect(env, mesh, N, A, n_ranks=1)
with mesh:
    txt = jitted.lower(params, st_b, obs_b, key).compile().as_text()
print(json.dumps(hlo_analysis.analyze(txt)))
"""


def small_env() -> EnvConfig:
    return EnvConfig(grid=GridConfig(res=RES, dt=0.005, poisson_iters=SOR),
                     steps_per_action=DT_A, actions_per_episode=ACTIONS,
                     warmup_time=0.0)


def port_counts(backend):
    return dryrun_drl.count_collect(
        small_env(), N_ENVS, ACTIONS, backend=backend,
        mesh=make_abstract_mesh((1, 1), ("data", "model")))


@pytest.fixture(scope="module")
def reference_hlo(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_drl")
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=1",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    code = textwrap.dedent(_CHILD.format(n=N_ENVS, a=ACTIONS, res=RES,
                                         sor=SOR, dt=DT_A))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collect_flops_match_the_reference(reference_hlo):
    """One action times the actions plus the postprocess, on the reference
    solver: within 2% of the reference's scaled scan."""
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


def test_more_ranks_are_refused():
    with pytest.raises(ValueError, match="n_ranks"):
        dryrun_drl.count_collect(small_env(), 2, 1, n_ranks=2)
