"""The "halo" backend through the port's env, engine, ``train()`` and
``autotune``, against the reference's.

The port runs on the CPU with ``REPRO_TORCH_FORCE_DEVICE_COUNT`` set, so
the host's one device serves a plan's workers: every x-slab of an env
sits on it.  The reference needs a forced multi-device host for its
meshes, so its side runs once, in one child process
(``XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu``,
the pattern of its own ``tests/test_halo_backend.py``) that writes an
``.npz``: a fixed-action rollout of a mixed scenario batch through the
engine's step, un-decomposed and on a (2, 2) mesh, and ``train()`` under
``ParallelPlan(4, 2, 2)`` and under ``ParallelPlan(2, 2, 1)`` with its PPO
batches recorded.  The port's ``train()`` gets the reference's initial
params, rollout noise and PPO permutations (``test_torch_train``'s
streams and sizes: 2 envs, the hybrid plan's data axis).

The reference's halo step is off on this jax (0.9, forced CPU devices):
its pressure solve is the monolithic one, but the velocity correction
that follows it differs from the un-decomposed step's by 8.6e-5 in u at
the first interior face of the second slab after one dt (res 6, dt
0.012, two ranks), which the flow then amplifies (2e-3 in C_D after 15
dt, ``ROADMAP.md`` §3).  The port's halo step is the monolithic one, bit
for bit on the CPU.  So the port's halo runs are held at
``test_torch_train``'s tolerances against the reference's un-decomposed
runs (which the halo iteration at ``halo_inner=1`` reproduces), and
against the reference's halo runs at the reference's own gate for its
halo path (0.05 on the mixed batch)."""
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.drl import ppo as jppo
from repro_torch.cfd import decomp
from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import autotune as tat
from repro_torch.core.plan import ParallelPlan
from repro_torch.drl import engine as tengine
from repro_torch.drl import train as ttrain
from repro_torch.drl.ppo import Batch
from repro_torch.launch.mesh import mesh_for_plan
from tests import test_torch_async as ta
from tests import test_torch_solver as ts
from tests import test_torch_train as tt
from tests._torch_parity import max_diff

SRC = str(Path(__file__).resolve().parent.parent / "src")

# the reference's mixed-batch test (tests/test_halo_backend.py)
MIXED_GRID = dict(res=6, dt=0.012, poisson_iters=40)
MIXED_ENV = dict(steps_per_action=5, warmup_time=2.0)
SCENARIOS = ("cyl_re100", "cyl_re100_rotary", "cyl_re200", "cyl_re100")
ACTIONS = (0.3, -0.2, 0.1)
FIELDS = ("reward", "cd", "cl", "obs")
# train(): test_torch_train's sizes, its 2 envs on the hybrid plan's data
# axis of 2 (2 x 2 workers); the reference's single-rank run of the same
# batch takes (2, 2, 1)
PLAN, PLAIN_PLAN = (4, 2, 2), (2, 2, 1)

_CHILD = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.cfd.env import CylinderEnv, EnvConfig
from repro.cfd.grid import GridConfig
from repro.core.plan import ParallelPlan
from repro.drl.engine import shard_env_batch
from repro.drl.train import TrainConfig, train
from repro.launch.mesh import mesh_for_plan

from repro.cfd import solver
from repro.cfd.grid import build_geometry

out = {{}}
grid = GridConfig(**{mixed_grid!r})
geom = build_geometry(grid)
ga, st = solver.geom_to_arrays(geom), solver.init_state(grid, geom)
for tag, kw in (("plain", {{}}),
                ("halo", dict(backend="halo", mesh=mesh_for_plan((1, 2))))):
    st1, _ = solver.step(grid, ga, st, jnp.float32(0.3), **kw)
    for f in ("u", "v", "p"):
        out[f"step_{{tag}}_{{f}}"] = np.asarray(getattr(st1, f))

cfg = EnvConfig(grid=GridConfig(**{mixed_grid!r}), **{mixed_env!r})
for tag, backend, mesh in (("plain", None, None),
                           ("halo", "halo",
                            mesh_for_plan(ParallelPlan(4, 2, 2)))):
    env = CylinderEnv(cfg, backend=backend, mesh=mesh)
    st_b, _ = env.reset_batch({scenarios!r}, 4)
    if mesh is not None:
        st_b = shard_env_batch(mesh, st_b, 2)

    def period(st_b, a, env=env):
        return jax.vmap(env.env_step, in_axes=(0, None))(st_b, a)

    _, outs = jax.jit(lambda s: jax.lax.scan(
        period, s, jnp.array({actions!r})))(st_b)
    for f in {fields!r}:
        out[f"mixed_{{tag}}_{{f}}"] = np.asarray(getattr(outs, f))

class Recorder:
    def __init__(self):
        self.batches = []
    def exchange(self, batch):
        self.batches.append(jax.tree.map(np.asarray, batch))
        return batch

for tag, plan in (("halo", {plan!r}), ("plain", {plain_plan!r})):
    rec, logs = Recorder(), []
    hist, _ = train(TrainConfig(
        env=EnvConfig(grid=GridConfig(res=6), **{env_kw!r}),
        n_envs={n_envs}, episodes={episodes}, seed={seed},
        plan=ParallelPlan(*plan)), log_fn=logs.append, interface=rec)
    out[tag + "_plan_line"] = np.array(
        [l for l in logs if "plan[explicit]" in l][0])
    for k, v in hist.items():
        out[f"{{tag}}_hist_{{k}}"] = np.asarray(v)
    for e, b in enumerate(rec.batches):
        for f in b._fields:
            if getattr(b, f) is not None:
                out[f"{{tag}}_batch{{e}}_{{f}}"] = np.asarray(getattr(b, f))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("halo")
    code = _CHILD.format(mixed_grid=MIXED_GRID, mixed_env=MIXED_ENV,
                         scenarios=SCENARIOS, actions=ACTIONS, fields=FIELDS,
                         env_kw=tt.ENV_KW, n_envs=tt.N_ENVS,
                         episodes=tt.EPISODES, seed=tt.SEED, plan=PLAN,
                         plain_plan=PLAIN_PLAN)
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PYTHONPATH": SRC,
           "PATH": "/usr/bin:/bin", "HOME": str(d)}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(d / "out.npz")], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture
def workers(monkeypatch):
    """Four plan workers served by the CPU."""
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, "4")


# ---------------------------------------------------------------------------
# one solver step at two ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["u", "v", "p"])
def test_one_halo_step_is_the_plain_step(reference, field, monkeypatch):
    """One dt from the initial flow (res 6, dt 0.012, amplitude 0.3) with
    the pressure solve on two slabs: the port's halo step is its plain
    step bit for bit, and within test_torch_solver's tolerances of the
    reference's plain step.  The reference's own halo step
    (``step_halo_*`` beside ``step_plain_*`` in the child's output) reads
    its pressure equal to its plain step's but u 8.6e-5 off along one
    face column inside the second slab, on jax 0.9 with forced CPU
    devices; it stays inside the reference's own 0.05 gate."""
    from repro_torch.cfd import solver
    from repro_torch.cfd.grid import build_geometry
    monkeypatch.setenv(tat.FORCE_DEVICE_COUNT, "2")
    grid = GridConfig(**MIXED_GRID)
    geom = build_geometry(grid)
    ga, st = solver.geom_to_arrays(geom, "cpu"), solver.init_state(
        grid, geom, "cpu")
    plain, _ = solver.step(grid, ga, st, torch.tensor(0.3))
    halo, _ = solver.step(grid, ga, st, torch.tensor(0.3), backend="halo",
                          mesh=mesh_for_plan((1, 2), device="cpu"))
    ours = getattr(halo, field).numpy()
    assert np.array_equal(ours, getattr(plain, field).numpy())
    atol = {"u": ts.ATOL_UV, "v": ts.ATOL_UV, "p": ts.ATOL_P}[field]
    assert max_diff(reference[f"step_plain_{field}"], ours)[0] <= atol
    assert max_diff(reference[f"step_halo_{field}"], ours)[0] < 0.05


# ---------------------------------------------------------------------------
# the engine's step on a (2, 2) mesh: a mixed scenario batch
# ---------------------------------------------------------------------------

def _mixed_rollout(backend, mesh):
    """Fixed shared actions (a stochastic policy would chaos-amplify the
    solvers' rounding into trajectory divergence, physics and not a
    defect), the batch placed by ``shard_env_batch``."""
    env = CylinderEnv(EnvConfig(grid=GridConfig(**MIXED_GRID), **MIXED_ENV),
                      backend=backend, mesh=mesh, device="cpu")
    st_b, _ = env.reset_batch(SCENARIOS, 4)
    if mesh is not None:
        st_b = tengine.shard_env_batch(mesh, st_b, 2)
    outs = {f: [] for f in FIELDS}
    with decomp.record_messages() as log:
        for a in ACTIONS:
            st_b, out = env.env_step(st_b, torch.full((4,), a))
            for f in FIELDS:
                outs[f].append(getattr(out, f).numpy())
    return {**{f: np.stack(v) for f, v in outs.items()}, "messages": log}


@pytest.fixture(scope="module")
def mixed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tat.FORCE_DEVICE_COUNT, "4")
        mesh = mesh_for_plan(ParallelPlan(*PLAN), device="cpu")
        return dict(halo=_mixed_rollout("halo", mesh),
                    plain=_mixed_rollout(None, None))


# the port's halo rollout against the reference's un-decomposed one: the
# same sweeps, flows ~1e-4 apart after the warmup (test_torch_train),
# reward and forces O(1-5), the probe observations O(2.5)
MIXED_ATOL = {"reward": 1e-3, "cd": 1e-3, "cl": 1e-3, "obs": 2e-3}


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_batch_matches_the_reference(reference, mixed, field):
    out, ref = mixed["halo"][field], reference["mixed_plain_" + field]
    assert np.isfinite(out).all()
    assert max_diff(ref, out)[0] <= MIXED_ATOL[field], field


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_batch_within_the_reference_halo_gate(reference, mixed, field):
    """Against the reference's own (2, 2) halo rollout, at the gate the
    reference holds that rollout to (0.05 of its un-decomposed one)."""
    ref = reference["mixed_halo_" + field]
    assert np.isfinite(ref).all()
    assert max_diff(ref, mixed["halo"][field])[0] < 0.05, field


def test_mixed_batch_went_through_the_halo_exchange(mixed):
    """Every dt of the halo rollout solved on two slabs: 4 half-width
    messages (ceil(26 / 2) = 13 values) per rank boundary per sweep pair,
    40 pairs, 15 dt; the un-decomposed rollout sent none."""
    log = mixed["halo"]["messages"]
    assert {shape for shape, _ in log} == {(13, 1)}
    assert sum(n for _, n in log) == 4 * 40 * len(ACTIONS) * 5
    assert mixed["plain"]["messages"] == []


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_batch_halo_is_the_plain_step(mixed, field):
    """halo_inner = 1 makes the decomposed solve the monolithic one: on
    the CPU the (2, 2) rollout equals the un-decomposed one bit for bit
    (res 6: slabs of 66 columns, packed)."""
    assert np.array_equal(mixed["plain"][field], mixed["halo"][field])


# ---------------------------------------------------------------------------
# train() under a hybrid plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid_train():
    """The port's ``train(plan=ParallelPlan(4, 2, 2))`` on 4 forced CPU
    workers with the reference's streams injected; every PPO batch and
    each update's inputs and result recorded."""
    cfg = ttrain.TrainConfig(env=EnvConfig(grid=GridConfig(res=6),
                                           **tt.ENV_KW),
                             n_envs=tt.N_ENVS, episodes=tt.EPISODES,
                             seed=tt.SEED, plan=ParallelPlan(*PLAN),
                             device="cpu")
    batches, updates, logs = [], [], []
    ppo_update = tengine.ppo_update

    def recording_update(ppo_cfg, optimizer, model, opt_state, batch, step,
                         **kw):
        batches.append(Batch(*(None if x is None else x.detach().numpy()
                               for x in batch)))
        rec = dict(params_in=params_to_numpy(model),
                   opt_in=ta._moments_to_numpy(model, opt_state),
                   step_in=int(step))
        out = ppo_update(ppo_cfg, optimizer, model, opt_state, batch, step,
                         **kw)
        rec.update(params_out=params_to_numpy(model), step_out=int(out[1]))
        updates.append(rec)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tat.FORCE_DEVICE_COUNT, "4")
        params0, noise, perms, update_keys = tt._reference_streams(
            tt.N_ENVS * tt.ENV_KW["actions_per_episode"], cfg.ppo.epochs)
        mp.setattr(tengine, "ppo_update", recording_update)
        with decomp.record_messages() as messages:
            hist, model = ttrain.train(
                cfg, log_fn=logs.append,
                model=params_from_jax(params0, device="cpu"), noise=noise,
                perms=perms)
    return dict(hist=hist, model=model, batches=batches, updates=updates,
                logs=logs, params0=params0, update_keys=update_keys,
                messages=messages)


def test_hybrid_plan_line_is_the_reference(reference, hybrid_train):
    """The plan line, and the episodes' solves on two slabs (the warmup
    runs un-decomposed): 4 half-width messages per sweep pair, 60 pairs,
    2 episodes x 3 actions x 5 dt."""
    line = [m for m in hybrid_train["logs"] if "plan[explicit]" in m][0]
    assert "'halo'" in line and "2 x 2" in line
    log = hybrid_train["messages"]
    assert {shape for shape, _ in log} == {(13, 1)}
    assert sum(n for _, n in log) == 4 * 60 * tt.EPISODES * 3 * 5
    assert line == str(reference["halo_plan_line"])
    for f in ("reward", "cd", "cl"):
        assert np.isfinite(reference["halo_hist_" + f]).all()


@pytest.mark.parametrize("field", ["reward", "cd", "cl"])
def test_hybrid_train_metrics_match_the_reference(reference, hybrid_train,
                                                  field):
    """Per-episode returns and forces at ``test_torch_train``'s 1e-3,
    against the reference's run of the same seed and batch on one rank
    (see the module docstring)."""
    ref, out = reference["plain_hist_" + field], hybrid_train["hist"][field]
    assert np.isfinite(out).all()
    assert max_diff(ref, out)[0] <= tt.ATOL_EPISODE, (ref, out)


@pytest.mark.parametrize("field", sorted(tt.ATOL_BATCH))
def test_hybrid_first_batch_matches_the_reference(reference, hybrid_train,
                                                  field):
    """collect -> values -> GAE -> flatten through the halo env: the first
    PPO batch equals the reference's, sample for sample, at
    ``test_torch_train``'s tolerances."""
    assert len(hybrid_train["batches"]) == tt.EPISODES
    ref = reference[f"plain_batch0_{field}"]
    out = getattr(hybrid_train["batches"][0], field)
    assert out is not None, field
    assert max_diff(ref, out)[0] <= tt.ATOL_BATCH[field], field


def test_hybrid_updates_match_the_reference(hybrid_train):
    """Each update: the reference's ``ppo_update`` fed the port's batch,
    input params, Adam moments, step and the episode's key, against the
    params the port's update left, at ``test_torch_train``'s 1e-5."""
    ppo_cfg = jppo.PPOConfig()
    optimizer = jppo.make_optimizer(ppo_cfg)
    recs = hybrid_train["updates"]
    assert len(recs) == tt.EPISODES
    for e, rec in enumerate(recs):
        batch = jppo.Batch(*(None if x is None else jnp.asarray(x)
                             for x in hybrid_train["batches"][e]))
        params, _, step, _ = jppo.ppo_update(
            ppo_cfg, optimizer, jax.tree.map(jnp.asarray, rec["params_in"]),
            jax.tree.map(jnp.asarray, rec["opt_in"]), batch,
            hybrid_train["update_keys"][e], jnp.int32(rec["step_in"]))
        assert int(step) == rec["step_out"]
        ref = jax.tree.map(np.asarray, params)
        for a, o in zip(ta._leaves(ref), ta._leaves(rec["params_out"])):
            assert max_diff(a, o)[0] <= tt.ATOL_UPDATE, e


def test_hybrid_plan_needs_its_workers(monkeypatch, tmp_path):
    """Without forced workers, one device refuses the 4-worker plan with
    the reference's ValueError."""
    monkeypatch.delenv(tat.FORCE_DEVICE_COUNT, raising=False)
    with pytest.raises(ValueError, match=r"plan needs n_envs \* n_ranks = 4 "
                                         r"devices but this host has 1"):
        ttrain.train(ttrain.TrainConfig(
            env=EnvConfig(grid=GridConfig(res=6), **tt.ENV_KW), n_envs=4,
            episodes=1, plan=ParallelPlan(*PLAN), device="cpu"),
            log_fn=None)


# ---------------------------------------------------------------------------
# autotune over four workers; cross-plan resume
# ---------------------------------------------------------------------------

def test_autotune_measures_every_rank_count(workers):
    """Four workers: the step is timed at ranks 1, 2 and 4 (the halo
    backend beyond 1), and the refit model keeps the paper's n_ranks = 1,
    at the measured budget and at 60 workers."""
    from repro_torch.core.plan import optimize_plan
    rp = tat.autotune(grid=GridConfig(res=4, dt=0.01, poisson_iters=20),
                      smoke=True, device="cpu")
    measured = rp.measurements["measured"]
    assert sorted(measured["t_step_ranks"]) == [1, 2, 4]
    assert measured["t_step_backends"] == {1: "reference", 2: "halo",
                                           4: "halo"}
    assert rp.plan.n_ranks == 1
    assert optimize_plan(60, rp.model).n_ranks == 1
    assert {c["n_ranks"] for c in rp.measurements["candidates"]} == {1, 2, 4}


def test_cross_plan_resume_onto_the_halo_mesh(workers, tmp_path):
    """A checkpoint saved under (4, 1) resumes under (2, 2) with the halo
    backend: ``check_resume_compatible``'s note, the history continued,
    finite physics."""
    def cfg(episodes, plan, resume=None):
        return ttrain.TrainConfig(
            env=EnvConfig(grid=GridConfig(res=6, dt=0.012, poisson_iters=30),
                          steps_per_action=3, actions_per_episode=3,
                          warmup_time=1.0),
            n_envs=4, episodes=episodes, seed=0, plan=plan, device="cpu",
            ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, resume=resume)

    ttrain.train(cfg(1, (4, 1)), log_fn=None)
    logs = []
    hist, _ = ttrain.train(cfg(2, (2, 2), resume=True), log_fn=logs.append)
    assert any("'halo'" in m for m in logs), logs
    assert any(m.startswith("cross-plan resume") for m in logs), logs
    assert len(hist["reward"]) == 2
    assert np.isfinite(hist["reward"]).all() and np.isfinite(hist["cd"]).all()
