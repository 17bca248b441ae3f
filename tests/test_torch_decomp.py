"""The port's halo decomposition (``repro_torch.cfd.decomp``), its mesh
layer (``launch.mesh``, ``REPRO_TORCH_FORCE_DEVICE_COUNT``) and the
mesh-facing ``core.runner`` against the reference.

The same seeded numpy right-hand side goes to both packages.  The
reference's multi-rank halo needs a forced multi-device host, so it runs
once in a child process (``XLA_FLAGS=--xla_force_host_platform_device_count=4
JAX_PLATFORMS=cpu``, the reference's own halo tests' pattern) that writes
its solves to an ``.npz``; rank 1 runs in this process on its one device.
The port runs on the CPU, every slab of an env side by side on it; the
res-8 golden fixture runs through it at two ranks."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import decomp as jdecomp
from repro.cfd import poisson as jpoisson
from repro.launch.mesh import make_abstract_mesh
from repro.launch.mesh import mesh_for_plan as jmesh_for_plan
from repro_torch.cfd import decomp, poisson
from repro_torch.core import autotune as tat
from repro_torch.launch import mesh as tmesh
from tests._torch_parity import max_diff, to_np

SRC = str(Path(__file__).resolve().parent.parent / "src")
GOLDEN = Path(__file__).resolve().parent / "golden" / "cyl_re100_res8.npz"
DX, DY = 0.125, 0.12                   # the reference halo tests' spacing
NY, NX = 34, 176                       # the res-8 grid
ITERS, POLISH = 60, 10

# the reference's decomposed solve at every (ranks, halo_inner, packed)
CASES = [(r, inner, packed) for r in (1, 2, 4) for inner in (1, 4)
         for packed in (True, False)]

_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.cfd import decomp
from repro.launch.mesh import mesh_for_plan
rhs = jnp.asarray(np.load(sys.argv[1])["rhs"])
out = {{}}
for r, inner, packed in {cases!r}:
    out[f"{{r}}_{{inner}}_{{int(packed)}}"] = np.asarray(
        decomp.decomposed_solve(rhs, mesh=mesh_for_plan((1, r)), dx={dx},
                                dy={dy}, iters={iters}, inner_iters=inner,
                                polish={polish}, packed=packed))
np.savez(sys.argv[2], **out)
"""


def _rhs(seed=3):
    return np.random.default_rng(seed).standard_normal((NY, NX)).astype(
        np.float32)


def cpu_mesh(r: int, n_envs: int = 1) -> tmesh.Mesh:
    return tmesh.mesh_for_plan((n_envs, r), [torch.device("cpu")] * (
        n_envs * r))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's halo solves, from one forced 4-device child."""
    d = tmp_path_factory.mktemp("decomp")
    np.savez(d / "in.npz", rhs=_rhs())
    code = _CHILD.format(cases=CASES, dx=DX, dy=DY, iters=ITERS,
                         polish=POLISH)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _port(r, inner, packed, iters=ITERS, polish=POLISH):
    return decomp.decomposed_solve(torch.tensor(_rhs()), mesh=cpu_mesh(r),
                                   dx=DX, dy=DY, iters=iters,
                                   inner_iters=inner, polish=polish,
                                   packed=packed)


# ---------------------------------------------------------------------------
# solve parity
# ---------------------------------------------------------------------------

# the port's solves against the reference's halo solves: the same sweeps,
# rounded op by op in PyTorch and fused by XLA, on a solution of |p| ~ 0.22
# (60 pairs of a unit-variance rhs); every case reads at most 1.6e-6 on
# the CPU: test_torch_poisson's SOLVE_ATOL
REF_ATOL = 1e-5


@pytest.mark.parametrize("iters,polish,inner", [
    (24, 6, 1), (60, 10, 1), (7, 0, 1), (50, 10, 4), (24, 6, 3)])
def test_rank1_is_the_packed_solve(iters, polish, inner):
    """n_ranks = 1: the decomposed path IS the monolithic iteration for any
    inner_iters (live edge ghosts, exactly ``iters`` pairs, the same omega
    schedule): bit-equal to the port's packed solve, and within REF_ATOL
    of the reference's halo solve at rank 1 (the reference's cases)."""
    rhs = _rhs()
    a = poisson.solve(torch.tensor(rhs), DX, DY, iters=iters, polish=polish,
                      backend="packed")
    b = poisson.solve(torch.tensor(rhs), DX, DY, iters=iters, polish=polish,
                      backend="halo", mesh=cpu_mesh(1), halo_inner=inner)
    assert torch.equal(a, b)
    ref = jpoisson.solve(jnp.asarray(rhs), DX, DY, iters=iters,
                         polish=polish, backend="halo",
                         mesh=jmesh_for_plan((1, 1)), halo_inner=inner)
    assert max_diff(ref, b)[0] <= REF_ATOL


# block-Jacobi and the legacy frozen halos lag at the slab boundaries in
# both packages alike (the same iteration): REF_ATOL, as at rank 1
@pytest.mark.parametrize("r,inner,packed",
                         [c for c in CASES if c[0] > 1])
def test_multirank_matches_the_reference(reference, r, inner, packed):
    out = _port(r, inner, packed)
    ref = reference[f"{r}_{inner}_{int(packed)}"]
    assert np.isfinite(to_np(out)).all()
    assert max_diff(ref, out)[0] <= REF_ATOL, (r, inner, packed)


def test_rank1_child_matches_the_parent(reference):
    """The child's rank-1 solves (forced devices) are the parent's."""
    for inner in (1, 4):
        for packed in (True, False):
            ref = reference[f"1_{inner}_{int(packed)}"]
            assert max_diff(ref, _port(1, inner, packed))[0] <= REF_ATOL


@pytest.mark.parametrize("r", [2, 4])
def test_tight_coupling_is_monolithic(r):
    """halo_inner = 1 exchanges the updated parity before every half-sweep,
    so the decomposed iteration is the monolithic red-black sweep: within
    1e-5 relative of it at 400 pairs (the reference's bound, calibrated
    there at ~4e-7), the residual cut below 5% of the initial."""
    rhs = torch.tensor(_rhs())
    ref = poisson.solve(rhs, DX, DY, iters=400)
    h = poisson.solve(rhs, DX, DY, iters=400, backend="halo",
                      mesh=cpu_mesh(r), halo_inner=1)
    res0 = float(torch.linalg.norm(poisson.residual(torch.zeros_like(rhs),
                                                    rhs, DX, DY)))
    res = float(torch.linalg.norm(poisson.residual(h, rhs, DX, DY)))
    assert res < 0.05 * res0, res / res0
    assert float((h - ref).abs().max() / ref.abs().max()) < 1e-5


def test_legacy_path_matches_the_slab_smoother():
    """The legacy full-grid path keeps the block-Jacobi semantics of the
    slab smoother (2 slabs, halos refreshed every pair, no polish): within
    1e-4 relative of the port's plain twin of ``rb_sor(nslabs=2,
    inner_iters=1, packed=False)`` (the reference calibrated 2.6e-5)."""
    from repro_torch.kernels.poisson import ops as pops
    rhs = torch.tensor(_rhs())
    pal = pops.rb_sor(rhs, DX, DY, iters=200, omega=1.7, nslabs=2,
                      inner_iters=1, packed=False)
    h2 = _port(2, 1, False, iters=200, polish=0)
    assert float((h2 - pal).abs().max() / pal.abs().max()) < 1e-4


def test_batched_envs_solve_each_env():
    """Leading env dims: every env of a batch is solved as it is alone."""
    rhs = torch.stack([torch.tensor(_rhs(s)) for s in (3, 4, 5)])
    both = decomp.decomposed_solve(rhs, mesh=cpu_mesh(2), dx=DX, dy=DY,
                                   iters=24, inner_iters=1)
    for i in range(3):
        one = decomp.decomposed_solve(rhs[i], mesh=cpu_mesh(2), dx=DX, dy=DY,
                                      iters=24, inner_iters=1)
        assert torch.equal(both[i], one)


# ---------------------------------------------------------------------------
# golden physics at two ranks
# ---------------------------------------------------------------------------

def test_golden_physics_at_two_ranks(monkeypatch):
    """The res-8 fixture's 1600 dt through the halo backend on a (1, 2)
    mesh stay inside the golden gates of tests/test_golden_physics.py."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.cfd.validation import measure_shedding, run_uncontrolled
    from repro_torch.convert import flow_state_from_numpy
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, "2")
    ref = np.load(GOLDEN)
    cfg = GridConfig(res=int(ref["res"]), dt=float(ref["dt"]),
                     poisson_iters=int(ref["poisson_iters"]))
    state = flow_state_from_numpy(ref["u"], ref["v"], ref["p"], device="cpu")
    _, cds, cls = run_uncontrolled(
        cfg, state, int(ref["meas_steps"]), backend="halo",
        mesh=tmesh.mesh_for_plan((1, 2), device="cpu"))
    stats = measure_shedding(cds, cls, cfg.dt)
    TOL_ST, TOL_CD, TOL_AMP = 0.015, 0.01, 0.05      # = golden test gates
    for key, tol in (("strouhal", TOL_ST), ("cd_mean", TOL_CD),
                     ("cl_amp", TOL_AMP)):
        rel = abs(stats[key] - float(ref[key])) / abs(float(ref[key]))
        assert rel < tol, (key, rel)


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner,packed,width,per_round", [
    (1, True, 17, 4), (1, False, 34, 2), (4, True, 34, 2)])
@pytest.mark.parametrize("r", [1, 2, 4])
def test_message_widths_and_counts(r, inner, packed, width, per_round):
    """Packed tight coupling ships half columns (ceil(ny/2) = 17 values at
    ny 34), 4 per rank boundary per sweep pair; the legacy path and the
    block-Jacobi rounds ship full columns (34), one message pair per rank
    boundary per outer round.  Rank 1 sends nothing."""
    rhs = torch.tensor(_rhs()).expand(3, NY, NX)        # 3 envs
    with decomp.record_messages() as log:
        decomp.decomposed_solve(rhs, mesh=cpu_mesh(r), dx=DX, dy=DY,
                                iters=ITERS, inner_iters=inner,
                                packed=packed)
    rounds = -(-ITERS // inner)
    if r == 1:
        assert log == []
        return
    assert {shape for shape, _ in log} == {(width, 1)}
    assert sum(n for _, n in log) == per_round * rounds * (r - 1)
    assert width == jdecomp.halo_exchange_values(NY, packed=packed
                                                 and inner == 1)


def test_packed_halves_the_message():
    assert decomp.halo_exchange_values(NY) * 2 == \
        decomp.halo_exchange_values(NY, packed=False)
    for ny in (33, 34, 66):
        for packed in (True, False):
            assert decomp.halo_exchange_values(ny, packed) == \
                jdecomp.halo_exchange_values(ny, packed)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("shape,nx,axis", [
    ((2, 2), 88, "spatial"), ((1, 4), 89, "model"), ((1, 3), 88, "model")])
def test_validate_decomposition_errors_are_the_reference(shape, nx, axis):
    ours = _message(lambda: decomp.validate_decomposition(
        cpu_mesh(shape[1], shape[0]), nx, axis=axis))
    ref = _message(lambda: jdecomp.validate_decomposition(
        make_abstract_mesh(shape, ("data", "model")), nx, axis=axis))
    assert ours == ref


def test_validate_decomposition_ok():
    assert decomp.validate_decomposition(cpu_mesh(4), 88) == 4
    assert jdecomp.validate_decomposition(
        make_abstract_mesh((1, 4), ("data", "model")), 88) == 4


def test_packed_refuses_an_odd_slab():
    """nx 176 over 4 ranks: slabs of 44 columns; over 16: 11, odd."""
    rhs = torch.tensor(_rhs())
    msg = _message(lambda: decomp.decomposed_solve(
        rhs, mesh=cpu_mesh(16), dx=DX, dy=DY, packed=True))
    assert msg == ("packed halo sweeps need an even slab width and height, "
                   "got bx=11, ny=34 (nx=176 over 16 ranks); pass "
                   "packed=False or use an even-slab grid")
    # packed=None falls back to the legacy path there
    with decomp.record_messages() as log:
        decomp.decomposed_solve(rhs, mesh=cpu_mesh(16), dx=DX, dy=DY,
                                iters=2, inner_iters=1)
    assert {shape for shape, _ in log} == {(NY, 1)}


def test_halo_without_a_mesh_is_the_reference_error():
    rhs = _rhs()
    ours = _message(lambda: poisson.solve(torch.tensor(rhs), DX, DY,
                                          backend="halo"))
    ref = _message(lambda: jpoisson.solve(jnp.asarray(rhs), DX, DY,
                                          backend="halo"))
    assert ours == ref
    from repro_torch.cfd.env import CylinderEnv, EnvConfig
    with pytest.raises(ValueError, match=r"backend='halo' needs mesh="):
        CylinderEnv(EnvConfig(), backend="halo", device="cpu")


# ---------------------------------------------------------------------------
# the mesh layer
# ---------------------------------------------------------------------------

def test_mesh_for_plan_shapes_and_errors(monkeypatch):
    """One device serves one worker, as the reference's host does; forced
    workers cycle over the host's devices."""
    monkeypatch.delenv(tat.FORCE_DEVICE_COUNT, raising=False)
    one = tmesh.mesh_for_plan((1, 1), device="cpu")
    assert dict(one.shape) == {"data": 1, "model": 1}
    assert one.axis_names == ("data", "model")
    for make in (lambda: tmesh.mesh_for_plan((2, 2), device="cpu"),
                 lambda: jmesh_for_plan((2, 2))):
        with pytest.raises(ValueError, match=r"plan needs n_envs \* n_ranks "
                                             r"= 4 devices but this host "
                                             r"has 1"):
            make()
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, "4")
    assert tat.plan_devices("cpu") == [torch.device("cpu")] * 4
    mesh = tmesh.mesh_for_plan(tat.resolve_plan((2, 2), device="cpu"),
                               device="cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    assert tmesh.slab_device(mesh) == torch.device("cpu")
    assert dict(tmesh.make_debug_mesh(1, 4, device="cpu").shape) == \
        {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="host has 4"):
        tmesh.make_debug_mesh(3, 2, device="cpu")


def test_slabs_on_several_devices_are_refused():
    mesh = tmesh.Mesh(np.array([[torch.device("cpu"),
                                 torch.device("cuda", 0)]], dtype=object))
    with pytest.raises(NotImplementedError, match="several cards"):
        tmesh.slab_device(mesh)


def test_fleets_with_ranks_are_refused(monkeypatch):
    """Fleets with n_ranks > 1 run now (the name is kept from when they
    raised): over two processes the (2, 2) mesh puts each env's two
    workers on one process, the reference's intra-host halo rule; a share
    that splits an env raises the reference's ValueError; a fleet engine
    of a multi-rank plan constructs."""
    from repro_torch.core.autotune import ResolvedPlan
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.drl.engine import EngineConfig, RolloutEngine
    from repro_torch.launch import distributed as tdist
    monkeypatch.setattr(tdist, "fleet_info",
                        lambda: tdist.FleetInfo(2, 0, None))
    mesh = tmesh.mesh_for_plan((2, 2), span_processes=True, device="cpu")
    assert dict(mesh.shape) == {"data": 2, "model": 2}
    np.testing.assert_array_equal(mesh.processes, [[0, 0], [1, 1]])
    assert tmesh.slab_device(mesh) == torch.device("cpu")
    for plan in ((1, 2), (3, 2)):
        with pytest.raises(ValueError, match=r"cannot span 2 processes: each "
                                             r"process's \d+ workers must "
                                             r"hold whole envs \(a multiple "
                                             r"of n_ranks = 2\)"):
            tmesh.mesh_for_plan(plan, span_processes=True, device="cpu")
    monkeypatch.setenv(tdist.ENV_FLEET, "1")
    rp = ResolvedPlan(plan=ParallelPlan(4, 2, 2), backend="halo")
    engine = RolloutEngine(None, EngineConfig(n_envs=2, horizon=3,
                                              n_ranks=2, plan=rp,
                                              fleet=True), device="cpu")
    assert engine.cfg.n_ranks == 2 and engine.cfg.fleet
    np.testing.assert_array_equal(engine.mesh.processes, [[0, 0], [1, 1]])
    assert engine._shard() == (0, 1)


def test_shard_batch_places_on_the_mesh_device(monkeypatch):
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.drl.engine import env_state_specs, place_env_batch
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, "4")
    mesh = tmesh.mesh_for_plan((2, 2), device="cpu")
    batch = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
             "labels": np.ones((2, 3), np.int32)}
    out = shard_batch(batch, mesh)
    assert out["tokens"].device == torch.device("cpu")
    assert np.array_equal(out["tokens"].numpy(), batch["tokens"])
    assert shard_batch(batch, {"tokens": "cpu", "labels": mesh}).keys() == \
        batch.keys()
    assert env_state_specs(mesh) == (("data",), ("data", None, "model"))
    placed = place_env_batch(mesh, (torch.zeros(2, 4, 8), None), n_ranks=2)
    assert placed[1] is None and placed[0].shape == (2, 4, 8)


# ---------------------------------------------------------------------------
# core.runner: twins of tests/test_runner.py
# ---------------------------------------------------------------------------

def _runner_env(**kw):
    from repro_torch.cfd.env import CylinderEnv, EnvConfig
    from repro_torch.cfd.grid import GridConfig
    return CylinderEnv(EnvConfig(
        grid=GridConfig(res=6, dt=0.012, poisson_iters=30), **kw),
        device="cpu")


def test_distributed_collect_runs():
    from repro_torch.cfd.env import broadcast_env_state
    from repro_torch.core import runner
    from repro_torch.drl import networks
    env = _runner_env(steps_per_action=5, actions_per_episode=4,
                      warmup_time=2.0)
    st, obs = env.reset()
    n_envs, T = 2, 4
    st_b, obs_b = broadcast_env_state(st, obs, n_envs)
    model = networks.init_actor_critic(networks.PolicyConfig(),
                                       torch.Generator().manual_seed(0),
                                       device="cpu")
    collect, _ = runner.make_distributed_collect(
        env, tmesh.make_debug_mesh(1, 1, device="cpu"), n_envs, T)
    batch, traj = collect(model, st_b, obs_b,
                          generator=torch.Generator().manual_seed(1))
    assert batch.obs.shape == (n_envs * T, 149)
    assert batch.adv.shape == (n_envs * T,)
    assert not bool(torch.isnan(batch.adv).any())
    assert traj.cd.shape == (n_envs, T)


@pytest.mark.parametrize("r", [1, 2])
def test_sharded_cfd_step(r, monkeypatch):
    """One step with the pressure solve split over the mesh's "model"
    axis; at 2 slabs it is the monolithic step (one exchange per
    half-sweep)."""
    from repro_torch.cfd import solver
    from repro_torch.core import runner
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, str(r))
    env = _runner_env(warmup_time=0.0)
    st = solver.init_state(env.cfg.grid, env.geom, "cpu")
    step = runner.make_sharded_cfd_step(
        env, tmesh.make_debug_mesh(1, r, device="cpu"))
    st2, out = step(st, torch.tensor(0.1))
    assert st2.u.shape == st.u.shape
    assert not bool(torch.isnan(out.cd))
    plain, _ = solver.step(env.cfg.grid, env.geom_arrays, st,
                           torch.tensor(0.1))
    assert torch.equal(st2.p, plain.p)
