"""The port's multi-process fleet on the CPU, held to the reference's
(``tests/test_fleet.py``): launcher-driven bitwise parity across fleet
sizes, elastic kill -> shrink -> resume, per-process sink shards, the
distributed bootstrap helpers read and written across the two packages,
and ``autotune(max_processes=)``.

The heavyweight tests drive the real entry point, ``python -m
repro_torch.launch.fleet --device cpu``, which forks runner processes into
a gloo ``torch.distributed`` group.  They rendezvous through a file under
the test's own ``tmp_path`` (no ports to collide under ``pytest -n``),
every runner is pinned to one CPU thread, and every subprocess runs under
a timeout, the supervisor also under a heartbeat timeout: a hung gloo
collective fails its test instead of stopping the run.  Sizes: res 6, 4
envs, 3 actions of 3 dt, 2-3 episodes (~10 s a fleet)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.env import EnvConfig as JEnvConfig
from repro.cfd.grid import GridConfig as JGridConfig
from repro.drl import ppo as jppo
from repro.drl import train as jtrain
from repro.launch import distributed as jdist
from repro_torch.cfd.env import CylinderEnv, EnvConfig, broadcast_env_state
from repro_torch.cfd.grid import GridConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import autotune as tat
from repro_torch.core.plan import ParallelPlan
from repro_torch.drl import engine as tengine
from repro_torch.drl import networks, rollout
from repro_torch.drl import train as ttrain
from repro_torch.drl.engine import EngineConfig, RolloutEngine
from repro_torch.drl.ppo import Batch, PPOConfig
from repro_torch.launch import distributed as tdist
from repro_torch.launch import fleet as tfleet
from tests import test_torch_async as ta
from tests import test_torch_train as tt
from tests._torch_parity import max_diff

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
TIMEOUT_S = 240


def _launch(workdir, *extra, processes=1, episodes=2, expect_ok=True,
            env_extra=None):
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(workdir), "OMP_NUM_THREADS": "1", **(env_extra or {})}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--device", "cpu",
         "--processes", str(processes), "--episodes", str(episodes),
         "--workdir", str(workdir), "--heartbeat-timeout", "120",
         "--launch-timeout", str(TIMEOUT_S - 40), *map(str, extra)],
        capture_output=True, text=True, env=env, timeout=TIMEOUT_S,
        cwd=str(workdir.parent))
    if expect_ok:
        assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    return out


def _final_state(workdir):
    from repro_torch.ckpt.checkpoint import latest_checkpoint
    from repro_torch.drl.train_state import load_train_state
    path = latest_checkpoint(str(Path(workdir) / "ckpt"))
    assert path is not None, f"no checkpoint under {workdir}/ckpt"
    return load_train_state(path, "cpu")


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """A 1-process and a 2-process fleet of the same plan and seed, each
    recording a dataset sink."""
    base = tmp_path_factory.mktemp("fleets")
    out = {}
    for procs in (1, 2):
        wd = base / f"p{procs}"
        wd.mkdir()
        res = _launch(wd, "--sink-root", wd / "sink", processes=procs)
        out[procs] = dict(workdir=wd, stdout=res.stdout)
    return out


# ---------------------------------------------------------------------------
# the bitwise contract: N-process training == 1-process training
# ---------------------------------------------------------------------------

def test_two_process_training_bitwise_matches_single(fleets):
    """Same plan, same seed: the 2-process fleet and the 1-process fleet
    write identical final checkpoints (params, Adam moments, generator
    state, PPO step, env batch, history but its wall clock)."""
    for procs in (1, 2):
        assert "FLEET_DONE episodes=2" in fleets[procs]["stdout"]
    ts1, meta1 = _final_state(fleets[1]["workdir"])
    ts2, meta2 = _final_state(fleets[2]["workdir"])
    assert meta1["episode"] == meta2["episode"] == 2
    assert meta1["plan"]["n_processes"] == 1
    assert meta2["plan"]["n_processes"] == 2
    assert ts1.params.keys() == ts2.params.keys() and ts1.params
    for k in ts1.params:
        assert torch.equal(ts1.params[k], ts2.params[k]), k
    for k in ("m", "v"):
        assert len(ts1.opt_state[k]) == len(ts2.opt_state[k]) > 0
        for a, b in zip(ts1.opt_state[k], ts2.opt_state[k]):
            assert torch.equal(a, b), k
    assert torch.equal(ts1.rng, ts2.rng)
    assert ts1.step == ts2.step > 0
    assert torch.equal(ts1.obs, ts2.obs)
    for f, v in ts1.history.items():
        if f == "wall":                   # wall-clock seconds: not bitwise
            continue
        np.testing.assert_array_equal(v, ts2.history[f])


@pytest.fixture(scope="module")
def halo_fleets(tmp_path_factory):
    """A 1-process and a 2-process fleet at plan (4, 2, 2): 2 envs of 2
    x-slabs each on the halo backend, one env a process in the second."""
    base = tmp_path_factory.mktemp("halo_fleets")
    out = {}
    for procs in (1, 2):
        wd = base / f"p{procs}"
        wd.mkdir()
        res = _launch(wd, "--plan", "4,2,2", processes=procs,
                      env_extra={tat.FORCE_DEVICE_COUNT: "4"})
        out[procs] = dict(workdir=wd, stdout=res.stdout)
    return out


def test_halo_fleet_bitwise_matches_single(halo_fleets):
    """A fleet of a multi-rank plan: the 2-process fleet of plan (4, 2, 2)
    writes the 1-process fleet's final checkpoint bit for bit, and both
    ran the halo backend on a 2 x 2 mesh."""
    for procs in (1, 2):
        out = halo_fleets[procs]["stdout"]
        assert "FLEET_DONE episodes=2" in out
        assert "poisson backend 'halo'" in out and \
            "mesh (data, model) = (2, 2)" in out, out[-2000:]
    ts1, meta1 = _final_state(halo_fleets[1]["workdir"])
    ts2, meta2 = _final_state(halo_fleets[2]["workdir"])
    for meta, procs in ((meta1, 1), (meta2, 2)):
        assert meta["episode"] == 2
        assert meta["plan"] == {"n_envs": 2, "n_ranks": 2, "backend": "halo",
                                "n_processes": procs}
    for k in ts1.params:
        assert torch.equal(ts1.params[k], ts2.params[k]), k
    for k in ("m", "v"):
        for a, b in zip(ts1.opt_state[k], ts2.opt_state[k]):
            assert torch.equal(a, b), k
    assert torch.equal(ts1.rng, ts2.rng) and ts1.step == ts2.step > 0
    assert torch.equal(ts1.obs, ts2.obs)
    assert torch.equal(ts1.env_state.flow.u, ts2.env_state.flow.u)
    for f, v in ts1.history.items():
        if f != "wall":
            np.testing.assert_array_equal(v, ts2.history[f])


def test_fleet_autotune_times_every_rank_count(tmp_path):
    """``autotune(max_processes=2)`` inside a 2-process fleet of 2 forced
    workers a process times ranks 1 and 2, as the reference times every
    candidate rank count, and its lattice holds the reference's fleet x
    rank layouts of the 4-worker budget: those of 2 processes (a process
    has 2 workers), with rank counts that fit a process."""
    from repro.core import plan as jplan
    res = _launch(tmp_path, "--plan", "auto", "--n-envs", "2", processes=2,
                  episodes=1, env_extra={tat.FORCE_DEVICE_COUNT: "2"})
    assert "FLEET_DONE episodes=1" in res.stdout
    rec = json.loads((tmp_path / "autotune.json").read_text())
    tat.validate_artifact(rec)
    measured = rec["measured"]
    assert measured["n_total"] == 4
    assert sorted(int(r) for r in measured["t_step_ranks"]) == [1, 2]
    assert measured["t_step_backends"] == {"1": "reference", "2": "halo"}
    assert measured["t_interhost"]["estimated"] is False
    want = [(p.n_envs, p.n_ranks, p.n_processes)
            for p in jplan.enumerate_plans(4, 2)
            if p.n_ranks in (1, 2) and 4 // p.n_processes <= 2]
    assert (2, 2, 2) in want
    assert [(c["n_envs"], c["n_ranks"], c["n_processes"])
            for c in rec["candidates"]] == want
    assert rec["plan"]["n_processes"] == 2


def test_fleet_reports_its_gather(fleets):
    """Every runner prints its rollout / gather split; the 2-process fleet
    gathered the same bytes as the 1-process one (the full trajectory)."""
    def timing(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("FLEET_TIMING")][-1]
        return dict(kv.split("=") for kv in line.split()[1:])
    t1 = timing(fleets[1]["stdout"])
    t2 = timing(fleets[2]["stdout"])
    log1 = (fleets[2]["workdir"] / "runner_gen0_p001.log").read_text()
    t2b = timing(log1)
    assert (t1["process"], t2["process"], t2b["process"]) == ("0", "0", "1")
    assert int(t1["gather_bytes"]) == int(t2["gather_bytes"]) \
        == int(t2b["gather_bytes"]) > 0
    assert float(t2["gather_s"]) > 0 and float(t2b["gather_s"]) > 0
    stats = json.loads([ln for ln in fleets[2]["stdout"].splitlines()
                        if ln.startswith("FLEET_STATS")][-1].split(" ", 1)[1])
    assert stats["processes"] == 2 and stats["episodes"] == 2
    assert stats["health"]["rollbacks"] == 0


def test_sink_shards_hold_each_process_rows(fleets):
    """Each runner of the 2-process fleet spills only its env rows (its
    own ``part{NNN}``); together they are the 1-process run's episodes."""
    from repro_torch.data.trajectory_dataset import TrajectoryReader
    flat = TrajectoryReader(str(fleets[1]["workdir"] / "sink"))
    parts = [TrajectoryReader(str(fleets[2]["workdir"] / "sink"
                                  / f"part{p:03d}")) for p in (0, 1)]
    assert flat.episodes == parts[0].episodes == parts[1].episodes == [0, 1]
    for ep in (0, 1):
        whole = flat.read(ep)
        for p, reader in enumerate(parts):
            shard = reader.read(ep)
            for f, a, b in zip(whole._fields, whole, shard):
                if a is None:
                    assert b is None, f
                    continue
                np.testing.assert_array_equal(np.asarray(a)[2 * p:2 * p + 2],
                                              np.asarray(b), err_msg=f)


# ---------------------------------------------------------------------------
# elastic: a killed runner shrinks the fleet, which resumes to the target
# ---------------------------------------------------------------------------

def test_killed_runner_shrinks_and_resumes(tmp_path):
    wd = tmp_path / "elastic"
    wd.mkdir()
    out = _launch(wd, "--kill-process", 1, "--kill-episode", 1,
                  processes=2, episodes=3).stdout
    assert "FLEET_SHRINK gen=1 procs=2->1 reason=exit" in out, out
    assert "FLEET_DONE episodes=3" in out, out
    ts, meta = _final_state(wd)
    assert meta["episode"] == 3 and meta["plan"]["n_processes"] == 1
    assert len(ts.history["reward"]) == 3


def test_a_runner_that_fails_fails_the_fleet(tmp_path):
    """No fallback: a runner dying of anything but the injected kill (here:
    its sink root is a file, so the sink cannot be made) exits the
    supervisor non-zero instead of shrinking on."""
    wd = tmp_path / "bad"
    wd.mkdir()
    (tmp_path / "not_a_dir").write_text("")
    out = _launch(wd, "--sink-root", tmp_path / "not_a_dir", processes=1,
                  episodes=1, expect_ok=False)
    assert out.returncode != 0
    assert "FLEET_SHRINK" not in out.stdout
    assert "fleet failed" in out.stderr


def test_bench_mode_reports_throughput(tmp_path):
    """``--mode bench``: timed collects after a warmup; process 0 reports
    the reference's FLEET_STATS keys, and with REPRO_FLEET_TIMING=1 its
    rollout / gather split."""
    wd = tmp_path / "bench"
    wd.mkdir()
    env_extra = {"REPRO_FLEET_TIMING": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--device", "cpu",
         "--processes", "1", "--mode", "bench", "--measure-episodes", "1",
         "--workdir", str(wd), "--heartbeat-timeout", "120"],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=str(tmp_path),
        env={"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin"),
             "HOME": str(wd), "OMP_NUM_THREADS": "1", **env_extra})
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    stats = json.loads([ln for ln in out.stdout.splitlines()
                        if ln.startswith("FLEET_STATS")][-1].split(" ", 1)[1])
    assert set(stats) == {"processes", "episodes", "n_envs", "gather",
                          "env_steps", "elapsed_s", "env_steps_per_sec"}
    assert stats["env_steps"] == 4 * 3 * 3 and stats["gather"] is True
    assert "FLEET_TIMING process=0" in out.stdout


def test_bench_mode_runs_a_multi_rank_plan(tmp_path):
    """``--mode bench`` at plan (4, 2, 2) over 2 runners: each runner
    steps its env's two slabs on the halo backend and process 0 reports
    the 2 envs' steps."""
    out = _launch(tmp_path, "--plan", "4,2,2", "--mode", "bench",
                  "--measure-episodes", "1", processes=2,
                  env_extra={"REPRO_FLEET_TIMING": "1"})
    stats = json.loads([ln for ln in out.stdout.splitlines()
                        if ln.startswith("FLEET_STATS")][-1].split(" ", 1)[1])
    assert (stats["processes"], stats["n_envs"]) == (2, 2)
    assert stats["env_steps"] == 2 * 3 * 3 and stats["env_steps_per_sec"] > 0


# ---------------------------------------------------------------------------
# the fleet rollout's invariance (in process)
# ---------------------------------------------------------------------------

def test_per_env_policy_makes_actions_independent_of_the_batch():
    """``per_env`` gives an env the same action and log-prob bit for
    bit whether its batch holds 4 envs or its 2-env shard."""
    gen = torch.Generator().manual_seed(0)
    model = networks.init_actor_critic(networks.PolicyConfig(obs_dim=149),
                                       gen, device="cpu")
    obs = torch.randn((4, 149), generator=gen)
    eps = torch.randn((4, 1), generator=gen)
    whole = rollout._policy(model, obs, None, eps, None, True)
    shard = rollout._policy(model, obs[2:].clone(), None, eps[2:].clone(),
                            None, True)
    for a, b in zip(whole, shard):
        assert torch.equal(a[2:], b)


def test_fleet_engine_needs_a_plan():
    with pytest.raises(ValueError, match="fleet=True.*needs a plan"):
        RolloutEngine(None, EngineConfig(n_envs=2, horizon=3, fleet=True),
                      device="cpu")


# the fleet collect against the plain one, field by field: the fleet's
# per-env policy calls differ from the batched matmul in the last bits
# (~1e-7 in the actions), which two intervals of flow carry into the
# observations and forces -> 1e-5; the probe geometry, the masks and the
# step count are exact
ATOL_COLLECT = {"obs": 1e-5, "act": 1e-5, "logp": 1e-5, "reward": 1e-5,
                "cd": 1e-5, "cl": 1e-5, "last_obs": 1e-5, "probe_xy": 0.0,
                "probe_mask": 0.0, "valid": 0.0}


def test_one_process_fleet_collects_the_whole_batch(monkeypatch):
    """A 1-process fleet (``REPRO_FLEET=1``) spans the plan's 4 groups on
    its one device, rolls out all 4 envs, draws the noise a plain collect
    draws (the generators end equal) and gathers the whole trajectory:
    every field, rebuilt from the host copy's columns, equals the plain
    collect's in shape and dtype and within ``ATOL_COLLECT``."""
    monkeypatch.setenv(tdist.ENV_FLEET, "1")
    assert tdist.fleet_active()
    rp = tat.resolve_plan(ParallelPlan(4, 4, 1), device="cpu")
    assert rp.build_mesh("cpu") == [(0, torch.device("cpu"))] * 4
    env = CylinderEnv(EnvConfig(grid=GridConfig(res=6), steps_per_action=3,
                                actions_per_episode=2, warmup_time=0.2),
                      backend="fused", device="cpu")
    st, obs = env.reset()
    st_b, obs_b = broadcast_env_state(st, obs, 4)
    fleet = RolloutEngine.for_env(env, EngineConfig(n_envs=4, horizon=2,
                                                    plan=rp, fleet=True))
    plain = RolloutEngine.for_env(env, EngineConfig(n_envs=4, horizon=2))
    model, _, _, g1 = fleet.init(networks.PolicyConfig(obs_dim=149),
                                 PPOConfig(), 0, "cpu")
    g2 = torch.Generator().manual_seed(0)
    g2.set_state(g1.get_state())
    batch, traj = fleet.collect(model, st_b, obs_b, generator=g1)
    _, ref = plain.collect(model, st_b, obs_b, generator=g2)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert traj.obs.shape == ref.obs.shape == (4, 2, 149)
    assert batch.obs.shape == (8, 149)
    assert set(ATOL_COLLECT) == set(rollout.Trajectory._fields)
    for f, atol in ATOL_COLLECT.items():
        a, b = getattr(ref, f), getattr(traj, f)
        assert a is not None and b is not None, f
        assert (b.shape, b.dtype) == (a.shape, a.dtype), f
        assert max_diff(a, b)[0] <= atol, (f, max_diff(a, b))
    assert fleet.stats["gather_bytes"] > 0


# ---------------------------------------------------------------------------
# the fleet path of train() against the reference's train() (in process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_train():
    """``test_torch_train``'s gate, run through the fleet path: the port's
    ``train()`` as a 1-process fleet (``REPRO_FLEET=1``, plan (2, 2, 1) on
    the fused backend, as the launcher gives it) with the reference's
    initial params, noise and permutations injected, against the
    reference's plain ``train()`` at the same seed.  Both record the PPO
    batch of every episode; the port also each update's input params, Adam
    moments and step, and the params it left."""
    recorder = tt._BatchRecorder()
    ref_hist, _ = jtrain.train(
        jtrain.TrainConfig(env=JEnvConfig(grid=JGridConfig(res=6),
                                          **tt.ENV_KW),
                           n_envs=tt.N_ENVS, episodes=tt.EPISODES,
                           seed=tt.SEED),
        log_fn=None, interface=recorder)
    cfg = ttrain.TrainConfig(
        env=EnvConfig(grid=GridConfig(res=6), **tt.ENV_KW),
        n_envs=tt.N_ENVS, episodes=tt.EPISODES, seed=tt.SEED,
        plan=tat.ResolvedPlan(plan=ParallelPlan(tt.N_ENVS, tt.N_ENVS, 1),
                              backend="fused"),
        device="cpu")
    params0, noise, perms, update_keys = tt._reference_streams(
        tt.N_ENVS * tt.ENV_KW["actions_per_episode"], cfg.ppo.epochs)
    batches, updates, health = [], [], {}
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
        mp.setenv(tdist.ENV_FLEET, "1")
        mp.setattr(tengine, "ppo_update", recording_update)
        hist, model = ttrain.train(
            cfg, log_fn=None, model=params_from_jax(params0, device="cpu"),
            noise=noise, perms=perms, health=health)
    return dict(ref_hist=ref_hist, ref_batches=recorder.batches, hist=hist,
                model=model, batches=batches, updates=updates,
                health=health, params0=params0, update_keys=update_keys)


def test_fleet_train_took_the_fleet_path(fleet_train):
    """Every episode's trajectory went through the gather: 2 episodes of
    the whole batch's rows, nothing rolled back."""
    h = fleet_train["health"]
    assert h["fleet_gather_bytes"] > 0 and h["fleet_gather_s"] > 0
    assert h["fleet_gather_bytes"] % tt.EPISODES == 0
    assert h["rollbacks"] == 0
    assert len(fleet_train["batches"]) == tt.EPISODES


@pytest.mark.parametrize("field", ["reward", "cd", "cl"])
def test_fleet_train_metrics_match_the_reference(fleet_train, field):
    """Per-episode returns and forces at ``test_torch_train``'s 1e-3."""
    ref, out = fleet_train["ref_hist"][field], fleet_train["hist"][field]
    assert max_diff(ref, out)[0] <= tt.ATOL_EPISODE, (ref, out)


@pytest.mark.parametrize("field", sorted(tt.ATOL_BATCH))
def test_fleet_first_batch_matches_the_reference(fleet_train, field):
    """The gathered trajectory, rebuilt from its host columns, through
    values -> GAE -> flatten: the first PPO batch equals the reference's
    sample for sample, field by field at ``test_torch_train``'s
    tolerances (obs, act, logp, probe_xy, probe_mask and valid all pass
    through the rebuild)."""
    assert len(fleet_train["ref_batches"]) == tt.EPISODES
    ref = getattr(fleet_train["ref_batches"][0], field)
    out = getattr(fleet_train["batches"][0], field)
    assert ref is not None and out is not None, field
    assert max_diff(ref, out)[0] <= tt.ATOL_BATCH[field], field


def test_fleet_updates_match_the_reference(fleet_train):
    """The replicated update over the gathered batch, update by update:
    the reference's ``ppo_update``, fed the port's batch with its episode
    key from the port's input params, Adam moments and step, against the
    params the port's update left, at ``test_torch_train``'s 1e-5 (held
    from the port's inputs, not chained from the reference's own results:
    chained, Adam's sign-driven steps drift apart, ``test_torch_async``).
    Each update starts from the params the one before left, the first
    from the reference's initial params, and the final model is the last
    update's, exactly."""
    ppo_cfg = jppo.PPOConfig()
    optimizer = jppo.make_optimizer(ppo_cfg)
    recs = fleet_train["updates"]
    assert len(recs) == tt.EPISODES
    prev = fleet_train["params0"]
    for e, rec in enumerate(recs):
        for a, o in zip(ta._leaves(prev), ta._leaves(rec["params_in"])):
            assert max_diff(a, o)[0] == 0, e
        batch = jppo.Batch(*(None if x is None else jnp.asarray(x)
                             for x in fleet_train["batches"][e]))
        params, _, step, _ = jppo.ppo_update(
            ppo_cfg, optimizer, jax.tree.map(jnp.asarray, rec["params_in"]),
            jax.tree.map(jnp.asarray, rec["opt_in"]), batch,
            fleet_train["update_keys"][e], jnp.int32(rec["step_in"]))
        assert int(step) == rec["step_out"]
        ref = jax.tree.map(np.asarray, params)
        for a, o in zip(ta._leaves(ref), ta._leaves(rec["params_out"])):
            assert max_diff(a, o)[0] <= tt.ATOL_UPDATE, e
        prev = rec["params_out"]
    assert max_diff(fleet_train["params0"]["critic"][0]["w"],
                    prev["critic"][0]["w"])[0] > 1e-3   # the updates moved
    final = params_to_numpy(fleet_train["model"])
    for a, o in zip(ta._leaves(prev), ta._leaves(final)):
        assert max_diff(a, o)[0] == 0


# ---------------------------------------------------------------------------
# bootstrap helpers against the reference's (no fleet needed)
# ---------------------------------------------------------------------------

def test_fleet_env_matches_the_reference():
    base = {"PATH": "/usr/bin", "OMP_NUM_THREADS": "8"}
    ours = tdist.fleet_env("127.0.0.1:1234", 2, 1, n_total_devices=8,
                           heartbeat_dir="/tmp/hb", base=base)
    ref = jdist.fleet_env("127.0.0.1:1234", 2, 1, n_total_devices=8,
                          heartbeat_dir="/tmp/hb", base=base)
    repro_keys = {k for k in ref if k.startswith("REPRO_")}
    assert repro_keys == {k for k in ours if k.startswith("REPRO_")} == {
        jdist.ENV_COORDINATOR, jdist.ENV_NUM_PROCESSES, jdist.ENV_PROCESS_ID,
        jdist.ENV_FLEET, jdist.ENV_HEARTBEAT_DIR}
    for k in repro_keys:
        assert ours[k] == ref[k], k
    for name in ("ENV_COORDINATOR", "ENV_NUM_PROCESSES", "ENV_PROCESS_ID",
                 "ENV_FLEET", "ENV_HEARTBEAT_DIR"):
        assert getattr(tdist, name) == getattr(jdist, name)
    # the thread count is pinned the same at every fleet size
    threads = {tdist.fleet_env("a:1", p, 0, 4, base=base)["OMP_NUM_THREADS"]
               for p in (1, 2, 4)}
    assert threads == {str(tdist.FLEET_THREADS)}
    assert ours["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert ours["PATH"] == "/usr/bin"


def test_initialize_fleet_single_process_noop():
    info = tdist.initialize_fleet(num_processes=1)
    assert info.num_processes == 1 and info.is_coordinator
    live = tdist.fleet_info()
    assert (live.num_processes, live.process_id) == (1, 0)
    assert not torch.distributed.is_initialized()
    assert tdist.init_method("h:5") == "tcp://h:5"
    assert tdist.init_method("file:///x/y") == "file:///x/y"


def test_span_devices():
    assert tdist.span_devices(4, "cpu", num_processes=2) == [
        (0, torch.device("cpu")), (0, torch.device("cpu")),
        (1, torch.device("cpu")), (1, torch.device("cpu"))]
    with pytest.raises(ValueError, match="must divide evenly"):
        tdist.span_devices(3, "cpu", num_processes=2)


@pytest.mark.parametrize("writer,reader", [(tdist, jdist), (jdist, tdist)])
def test_heartbeats_cross_packages(tmp_path, writer, reader):
    """Beats one package writes, the other reads and ages, with the
    clock-skew rule: stale only when payload and mtime both age."""
    writer.write_heartbeat(str(tmp_path), 0, episode=3)
    writer.write_heartbeat(str(tmp_path), 1, episode=2)
    assert writer.heartbeat_path(str(tmp_path), 1).name == "hb_001.json"
    beats = reader.read_heartbeats(str(tmp_path))
    assert beats[0]["episode"] == 3 and beats[1]["pid"] == os.getpid()
    now = beats[1]["time"]
    for mod in (tdist, jdist):
        assert mod.stale_processes(str(tmp_path), 2, timeout=60,
                                   now=now) == []
        assert mod.stale_processes(str(tmp_path), 3, timeout=60,
                                   now=now + 120) == [0, 1]
    # a runner whose clock lags: its payload looks ancient, the fresh mtime
    # saves it, in both packages
    rec = json.loads(writer.heartbeat_path(str(tmp_path), 0).read_text())
    rec["time"] -= 1000
    writer.heartbeat_path(str(tmp_path), 0).write_text(json.dumps(rec))
    for mod in (tdist, jdist):
        assert mod.stale_processes(str(tmp_path), 2, timeout=60) == []


def test_heartbeat_reporter(tmp_path):
    hb = tdist.HeartbeatReporter(2, root=str(tmp_path))
    hb(None, None)
    hb(None, None)
    assert jdist.read_heartbeats(str(tmp_path))[2]["episode"] == 2
    inert = tdist.HeartbeatReporter(0, root=None)
    inert()
    assert inert.episodes == 1


def test_shrink_ladder_matches_the_reference():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        from launch_fleet import _shrink as ref_shrink
    finally:
        sys.path.pop(0)
    for n_total in range(1, 13):
        for n_ranks in (1, 2, 3, 4):
            for procs in range(1, 9):
                assert tfleet._shrink(n_total, n_ranks, procs) == \
                    ref_shrink(n_total, n_ranks, procs)
    assert tfleet._shrink(8, 1, 4) == 2 and tfleet._shrink(4, 1, 1) == 0


def test_launcher_args():
    args = tfleet.parse_args(["--device", "cpu"])
    assert (args.device, args.plan_tuple, args.n_envs) == \
        ("cpu", (4, 4, 1), 4)
    assert tfleet.parse_args([]).device == "cuda"
    assert tfleet.parse_args(["--plan", "auto", "--n-envs", "4"]
                             ).plan_tuple is None
    with pytest.raises(SystemExit):
        tfleet.parse_args(["--plan", "4,4"])


# ---------------------------------------------------------------------------
# autotune(max_processes=): the repair and the fleet layouts
# ---------------------------------------------------------------------------

def test_autotune_accepts_max_processes():
    """The reference's keyword, which raised TypeError before: one process
    keeps the single-process plan."""
    rp = tat.autotune(max_processes=1, smoke=True, device="cpu")
    assert rp.plan == ParallelPlan(1, 1, 1)
    assert rp.measurements["plan"]["n_processes"] == 1


def test_fleet_autotune_artifact_validates_in_both(tmp_path):
    """Two processes of one device each: the 2-worker budget fits only as
    a 2-process layout, by the reference's feasibility rule over its
    lattice; the artifact validates in both packages."""
    from repro.core import autotune as jat
    from repro.core import plan as jplan
    art = tmp_path / "port.json"
    rp = tat.autotune(n_total=2, max_processes=2, smoke=True, device="cpu",
                      grid=GridConfig(res=6), artifact=str(art))
    feasible = [(p.n_total, p.n_envs, p.n_ranks, p.n_processes)
                for p in jplan.enumerate_plans(2, 2)
                if p.n_ranks == 1 and 2 // p.n_processes <= 1]
    assert feasible == [(2, 2, 1, 2)]
    assert (rp.plan.n_total, rp.n_envs, rp.n_ranks, rp.n_processes) == \
        feasible[0]
    rec = json.loads(art.read_text())
    assert rec["plan"]["n_processes"] == 2
    assert [(c["n_envs"], c["n_processes"]) for c in rec["candidates"]] == \
        [(2, 2)]
    assert rec["measured"]["t_interhost"]["estimated"] is True
    tat.validate_artifact(rec)
    jat.validate_artifact(rec)


def test_train_plan_auto_with_max_processes(tmp_path):
    """``train(plan="auto", plan_args={"max_processes": 1})``, which raised
    TypeError before, trains."""
    from repro_torch.drl.train import TrainConfig, train
    cfg = TrainConfig(
        env=EnvConfig(grid=GridConfig(res=6), steps_per_action=3,
                      actions_per_episode=2, warmup_time=0.2),
        ppo=PPOConfig(epochs=1, minibatches=1), n_envs=1, episodes=1,
        plan="auto", plan_args={"max_processes": 1}, device="cpu")
    hist, _ = train(cfg, log_fn=None)
    assert len(hist["reward"]) == 1 and np.isfinite(hist["reward"]).all()
