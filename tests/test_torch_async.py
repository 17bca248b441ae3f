"""The port's asynchronous trainer against the reference's.

``RolloutEngine.run_async`` at res 6 (2 envs, 3 actions of 5 dt, 4
episodes: the sync gate's sizes in ``test_torch_train``) with the
reference's initial params, rollout noise and PPO permutations injected.
The reference's keys are re-derived as its ``run_async`` splits them:
``key, kr, ku = split(key, 3)`` per iteration, ``kr`` the collect's noise,
iteration *i*'s ``ku`` the update of episode *i-1*'s batch, and the
drain's ``ku`` from ``split(key)``.  Held:

- the schedule: collect *e* reads the learner's params after the update
  of *e-2* (the initial params for *e* < 2), exactly;
- the updates: each starts from the params, Adam moments and step the
  previous one left, exactly; the reference's ``ppo_update``, fed each
  update's batch, key, params, moments and step, against the learner the
  port's update left;
- the per-episode returns of the reference's own ``run_async``.

Then, torch against torch on a toy env: ``run_async`` equal to a serial
emulation of its schedule and to its own run with the noise and
permutations injected in the documented draw order; the ``on_state``
cadence; the sink; ``train_async`` learning, checkpointing, resuming and
rolling back; ``async_speedup`` against the reference's; a
``train(plan=(1, 1))`` run recording its plan."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.env import CylinderEnv as JCylinderEnv
from repro.cfd.env import EnvConfig as JEnvConfig
from repro.cfd.grid import GridConfig as JGridConfig
from repro.core import plan as jplan
from repro.core import scaling_model as jsm
from repro.drl import async_train as jasync
from repro.drl import engine as jengine
from repro.drl import networks as jnet
from repro.drl import ppo as jppo
from repro_torch.cfd.env import CylinderEnv, EnvConfig, broadcast_env_state
from repro_torch.cfd.grid import GridConfig
from repro_torch.ckpt import checkpoint as ck
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import plan as tplan
from repro_torch.core import scaling_model as tsm
from repro_torch.drl import async_train as tasync
from repro_torch.drl import engine as tengine
from repro_torch.drl import networks, rollout
from repro_torch.drl import train_state as ts_mod
from repro_torch.drl.engine import EngineConfig, FileSink, RolloutEngine
from repro_torch.drl.health import WatchdogConfig
from repro_torch.drl.ppo import Batch, PPOConfig, make_optimizer
from repro_torch.drl.train import TrainConfig, train
from repro_torch.testing import faults
from tests._torch_parity import max_diff

N_ENVS, EPISODES, SEED = 2, 4, 0
ENV_KW = dict(steps_per_action=5, actions_per_episode=3, warmup_time=1.0)
T = ENV_KW["actions_per_episode"]

# The sync gate's tolerances (test_torch_train), for the same reasons:
# per-episode returns O(1-5) from flows ~1e-4 apart, the probes ~8e-4 and
# the updates' ~2e-4 param differences carried into the next rollouts ->
# 1e-3; the same batches through both updates, 40 Adam steps of float32
# gradients differing in the last bits -> 1e-5.
ATOL_EPISODE = 1e-3
ATOL_UPDATE = 1e-5


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def _reference_streams(key, n_samples, epochs):
    """run_async's key splits: per iteration the collect noise (N, T, 1)
    from kr and the permutations of the update issued there (episode i-1's
    batch) from ku; the drain's from split(key)."""
    def perms(ku):
        return np.stack([np.asarray(jax.random.permutation(k, n_samples))
                         for k in jax.random.split(ku, epochs)])

    noise, update_keys = [], []
    for i in range(EPISODES):
        key, kr, ku = jax.random.split(key, 3)
        noise.append(np.stack([
            np.stack([np.asarray(jax.random.normal(k, (1,)))
                      for k in jax.random.split(ke, T)])
            for ke in jax.random.split(kr, N_ENVS)]))
        if i > 0:
            update_keys.append(ku)
    key, ku = jax.random.split(key)
    update_keys.append(ku)
    return noise, [perms(k) for k in update_keys], update_keys


def _moments_to_numpy(model, opt_state):
    """The port's Adam moments (lists in ``model.parameters()`` order) as
    the reference's {"m", "v"} trees."""
    out = {}
    for k in ("m", "v"):
        holder = copy.deepcopy(model)
        with torch.no_grad():
            for p, t in zip(holder.parameters(), opt_state[k]):
                p.copy_(t)
        out[k] = params_to_numpy(holder)
    return out


def _recording(updates):
    """Wrap ppo_update_steps: each update's batch, its input params, Adam
    moments and step, and what it leaves."""
    steps = tengine.ppo_update_steps

    def wrapper(ppo_cfg, optimizer, model, opt_state, batch, step, **kw):
        rec = dict(batch=Batch(*(None if x is None else x.detach().numpy()
                                 for x in batch)),
                   params_in=params_to_numpy(model),
                   opt_in=_moments_to_numpy(model, opt_state), step_in=step)
        out = yield from steps(ppo_cfg, optimizer, model, opt_state, batch,
                               step, **kw)
        rec.update(params_out=params_to_numpy(model),
                   opt_out=_moments_to_numpy(model, out[0]), step_out=out[1])
        updates.append(rec)
        return out
    return wrapper


@pytest.fixture(scope="module")
def runs():
    ppo_cfg = PPOConfig()
    # the reference's own run_async
    jenv = JCylinderEnv(JEnvConfig(grid=JGridConfig(res=6), **ENV_KW))
    jst, jobs = jenv.reset()
    jst_b, jobs_b = jengine.broadcast_env_state(jst, jobs, N_ENVS)
    jeng = jengine.RolloutEngine.for_env(jenv, jengine.EngineConfig(
        n_envs=N_ENVS, horizon=T, gamma=ppo_cfg.gamma, lam=ppo_cfg.lam))
    jppo_cfg = jppo.PPOConfig()
    params0, joptimizer, jopt_state, key = jeng.init(
        jnet.PolicyConfig(obs_dim=149), jppo_cfg, SEED)
    params0 = jax.tree.map(np.asarray, params0)
    noise, perms, update_keys = _reference_streams(key, N_ENVS * T,
                                                   ppo_cfg.epochs)
    _, _, ref_returns = jeng.run_async(
        jax.tree.map(jnp.asarray, params0), jopt_state, jppo_cfg,
        joptimizer, jst_b, jobs_b, key, EPISODES)

    # the port's, its streams injected
    env = CylinderEnv(EnvConfig(grid=GridConfig(res=6), **ENV_KW),
                      device="cpu")
    st, obs = env.reset()
    st_b, obs_b = broadcast_env_state(st, obs, N_ENVS)
    eng = RolloutEngine.for_env(env, EngineConfig(
        n_envs=N_ENVS, horizon=T, gamma=ppo_cfg.gamma, lam=ppo_cfg.lam))
    model = params_from_jax(params0, device="cpu")
    optimizer = make_optimizer(ppo_cfg)
    opt_state = optimizer.init(list(model.parameters()))
    updates, behaviour = [], []
    collect = rollout.rollout_batch

    def recording_collect(env_step_fn, policy, *a, **kw):
        behaviour.append(params_to_numpy(policy))
        return collect(env_step_fn, policy, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "ppo_update_steps", _recording(updates))
        mp.setattr(rollout, "rollout_batch", recording_collect)
        model, _, returns = eng.run_async(
            model, opt_state, ppo_cfg, optimizer, st_b, obs_b, EPISODES,
            noise=noise, perms=perms)
    return dict(params0=params0, update_keys=update_keys,
                ref_returns=np.asarray(ref_returns), returns=returns,
                updates=updates, behaviour=behaviour, model=model)


def _leaves(p):
    for side in ("actor", "critic"):
        for layer in p[side]:
            yield from (layer["w"], layer["b"])
    yield p["log_std"]


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _same_tree(a, b):
    return all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_collect_reads_the_learner_two_updates_back(runs):
    beh = runs["behaviour"]
    upd = [u["params_out"] for u in runs["updates"]]
    assert len(beh) == len(upd) == EPISODES
    assert _equal(beh[0], runs["params0"]) and _equal(beh[1],
                                                      runs["params0"])
    for e in range(2, EPISODES):
        assert _equal(beh[e], upd[e - 2]), e
        assert not _equal(beh[e], upd[e - 1]), e      # staleness is real


def test_updates_carry_the_learner(runs):
    """Each update starts from the params, Adam moments and step the
    previous one left (the first from the initial params, zero moments,
    step 0), and the last one's params are the returned model."""
    ups = runs["updates"]
    assert _equal(ups[0]["params_in"], runs["params0"])
    assert ups[0]["step_in"] == 0
    assert not any(np.any(x) for x in jax.tree.leaves(ups[0]["opt_in"]))
    for prev, cur in zip(ups, ups[1:]):
        assert _equal(cur["params_in"], prev["params_out"])
        assert _same_tree(cur["opt_in"], prev["opt_out"])
        assert cur["step_in"] == prev["step_out"] == prev["step_in"] + 40
    assert _equal(ups[-1]["params_out"], params_to_numpy(runs["model"]))


def test_updates_match_reference_on_the_same_batches(runs):
    """Update by update: the reference's ppo_update, fed the port's batch
    with its key from the port's input params, moments and step, against
    the params the port's update left.  (Chained from the reference's own
    results instead, the updates drift apart: Adam moves each weight by
    ~lr whatever its gradient's size, so a near-zero gradient component
    whose sign the ~1e-6 differences of one update flip moves by ~2 lr =
    6e-4 in the next.)"""
    ppo_cfg = jppo.PPOConfig()
    optimizer = jppo.make_optimizer(ppo_cfg)
    moved = 0.0
    for u, rec in enumerate(runs["updates"]):
        batch = jppo.Batch(*(None if x is None else jnp.asarray(x)
                             for x in rec["batch"]))
        params, _, step, _ = jppo.ppo_update(
            ppo_cfg, optimizer, jax.tree.map(jnp.asarray, rec["params_in"]),
            jax.tree.map(jnp.asarray, rec["opt_in"]), batch,
            runs["update_keys"][u], jnp.int32(rec["step_in"]))
        assert int(step) == rec["step_out"]
        ref = jax.tree.map(np.asarray, params)
        for a, o in zip(_leaves(ref), _leaves(rec["params_out"])):
            assert max_diff(a, o)[0] <= ATOL_UPDATE, u
        moved = max(moved, max_diff(rec["params_in"]["critic"][0]["w"],
                                    rec["params_out"]["critic"][0]["w"])[0])
    assert moved > 1e-3                      # the updates did move params


def test_returns_match_reference_run_async(runs):
    assert max_diff(runs["ref_returns"], runs["returns"])[0] <= ATOL_EPISODE


# ---------------------------------------------------------------------------
# torch against torch on a toy env
# ---------------------------------------------------------------------------

class _Out:
    def __init__(self, obs, reward):
        self.obs, self.reward = obs, reward
        self.cd = self.cl = torch.zeros_like(reward)
        self.valid = None


def _toy_step(st, a):
    new = st * 0.8 + torch.tensor([0.5, 0.0, 0.0]) * a[:, None]
    return new, _Out(new, -new[:, 0] ** 2)


TN, TT = 4, 8
TOY_PCFG = networks.PolicyConfig(obs_dim=3, act_dim=1, hidden=16)
TOY_PPO = PPOConfig(lr=1e-3, epochs=2, minibatches=2)


def _toy(sink=None):
    eng = RolloutEngine(_toy_step, EngineConfig(
        n_envs=TN, horizon=TT, gamma=TOY_PPO.gamma, lam=TOY_PPO.lam),
        sink=sink, device="cpu")
    model, optimizer, opt_state, gen = eng.init(TOY_PCFG, TOY_PPO, 0, "cpu")
    return eng, model, optimizer, opt_state, gen, torch.ones((TN, 3)) * 2.0


def _serial(eng, model, optimizer, opt_state, gen, st0, episodes):
    """run_async's schedule, one step at a time: refresh, the pending
    update's permutations drawn, the update run, then the collect."""
    behaviour, step, pending, returns = copy.deepcopy(model), 0, None, []

    def update(batch):
        perm = torch.stack([torch.randperm(batch.obs.shape[0], generator=gen)
                            for _ in range(TOY_PPO.epochs)])
        return tengine.ppo_update(TOY_PPO, optimizer, model, opt_state,
                                  batch, step, perms=perm)[:2]

    for _ in range(episodes):
        behaviour.load_state_dict(model.state_dict())
        if pending is not None:
            opt_state, step = update(pending)
        pending, traj = eng.collect(behaviour, st0, st0, generator=gen,
                                    record=False)
        returns.append(float(torch.mean(torch.sum(traj.reward, dim=1))))
    opt_state, step = update(pending)
    return model, opt_state, step, returns


def test_run_async_equals_its_serial_emulation():
    eng, model, optimizer, opt_state, gen, st0 = _toy()
    carry = []
    _, opt_a, ret_a = eng.run_async(model, opt_state, TOY_PPO, optimizer,
                                    st0, st0, 5, generator=gen,
                                    on_state=carry.append, state_every=99)
    eng2, model2, optimizer2, opt_state2, gen2, _ = _toy()
    _, opt_s, step_s, ret_s = _serial(eng2, model2, optimizer2, opt_state2,
                                      gen2, st0, 5)
    assert carry[-1].step == step_s == 5 * TOY_PPO.epochs \
        * TOY_PPO.minibatches
    assert ret_a.tolist() == ret_s
    assert torch.equal(gen.get_state(), gen2.get_state())
    for x, y in zip(model.parameters(), model2.parameters()):
        assert torch.equal(x, y)
    for k in ("m", "v"):
        assert all(torch.equal(x, y) for x, y in zip(opt_a[k], opt_s[k]))


def test_run_async_injected_streams_follow_the_draw_order():
    """noise[e] / perms[e] drawn beforehand in the documented order (the
    pending update's permutations, then the collect's noise) reproduce the
    generator-driven run."""
    eng, model, optimizer, opt_state, gen, st0 = _toy()
    _, _, ret = eng.run_async(model, opt_state, TOY_PPO, optimizer, st0,
                              st0, 3, generator=gen)
    eng2, model2, optimizer2, opt_state2, gen2, _ = _toy()
    n = TN * TT
    noise, perms = [], []
    for e in range(3):
        if e > 0:
            perms.append(torch.stack([torch.randperm(n, generator=gen2)
                                      for _ in range(TOY_PPO.epochs)]))
        noise.append(torch.stack([torch.randn((TN, 1), generator=gen2)
                                  for _ in range(TT)], dim=1))
    perms.append(torch.stack([torch.randperm(n, generator=gen2)
                              for _ in range(TOY_PPO.epochs)]))
    _, _, ret2 = eng2.run_async(model2, opt_state2, TOY_PPO, optimizer2,
                                st0, st0, 3, noise=noise, perms=perms)
    assert ret.tolist() == ret2.tolist()
    for x, y in zip(model.parameters(), model2.parameters()):
        assert torch.equal(x, y)


def test_run_async_on_state_cadence():
    eng, model, optimizer, opt_state, gen, st0 = _toy()
    snaps = []

    def on_state(c):
        snaps.append((c.step, [p.detach().clone()
                               for p in c.model.parameters()]))

    eng.run_async(model, opt_state, TOY_PPO, optimizer, st0, st0, 7,
                  generator=gen, on_state=on_state, state_every=3)
    k = TOY_PPO.epochs * TOY_PPO.minibatches
    # after episode 3: the updates of episodes 0-1 (2 is in flight); after
    # 6: 0-4; after the drain: all 7
    assert [s for s, _ in snaps] == [2 * k, 5 * k, 7 * k]
    assert all(torch.equal(x, y) for x, y in
               zip(snaps[-1][1], model.parameters()))
    assert not all(torch.equal(x, y) for x, y in
                   zip(snaps[0][1], snaps[1][1]))


def test_run_async_spills_every_episode(tmp_path):
    sink = FileSink(str(tmp_path), codec="binary")
    eng, model, optimizer, opt_state, gen, st0 = _toy(sink)
    eng.run_async(model, opt_state, TOY_PPO, optimizer, st0, st0, 5,
                  generator=gen)
    assert sink.episodes == 5
    for ep in range(5):
        assert sink.read(ep).obs.shape == (TN, TT, 3)


def test_async_ppo_still_learns():
    N, T_ = 8, 24
    st0 = torch.ones((N, 3)) * 2.0
    _, returns = tasync.train_async(
        _toy_step, networks.PolicyConfig(obs_dim=3, act_dim=1),
        PPOConfig(lr=1e-3, epochs=4, minibatches=4), st0, st0, n_envs=N,
        horizon=T_, episodes=25, device="cpu")
    assert np.mean(returns[-5:]) > np.mean(returns[:5]) + 0.1, \
        (np.mean(returns[:5]), np.mean(returns[-5:]))


def test_train_async_checkpoints_and_resumes(tmp_path):
    st0 = torch.ones((TN, 3)) * 2.0
    d = str(tmp_path / "async")
    kw = dict(n_envs=TN, horizon=TT, seed=0, ckpt_dir=d, ckpt_every=2,
              device="cpu")
    _, r1 = tasync.train_async(_toy_step, TOY_PCFG, TOY_PPO, st0, st0,
                               episodes=4, **kw)
    assert len(r1) == 4
    ts, _ = ts_mod.load_train_state(ck.latest_checkpoint(d), "cpu")
    assert ts.episode == 4 and len(ts.history["reward"]) == 4
    assert torch.equal(ts.env_state, st0)
    # resume without re-supplying the env batch: the checkpoint carries it
    model, r2 = tasync.train_async(_toy_step, TOY_PCFG, TOY_PPO, None, None,
                                   episodes=7, resume="auto", **kw)
    assert len(r2) == 7
    np.testing.assert_array_equal(r2[:4], r1)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    with pytest.raises(ck.CheckpointError, match="no valid checkpoint"):
        tasync.train_async(_toy_step, TOY_PCFG, TOY_PPO, st0, st0,
                           n_envs=TN, horizon=TT, episodes=2,
                           ckpt_dir=str(tmp_path / "void"), resume=True,
                           device="cpu")
    with pytest.raises(ck.CheckpointError, match="n_envs"):
        tasync.train_async(_toy_step, TOY_PCFG, TOY_PPO, None, None,
                           n_envs=2 * TN, horizon=TT, episodes=9,
                           ckpt_dir=d, resume=True, device="cpu")


def test_train_async_rolls_back(tmp_path):
    st0 = torch.ones((TN, 3)) * 2.0
    faults.configure({"watchdog": {"episode": 2}})
    model, rs = tasync.train_async(
        _toy_step, TOY_PCFG, TOY_PPO, st0, st0, n_envs=TN, horizon=TT,
        episodes=4, seed=0, ckpt_dir=str(tmp_path / "async"), ckpt_every=1,
        device="cpu")
    assert len(rs) == 4 and np.isfinite(rs).all()
    assert faults.active("watchdog") is None          # it fired, once
    assert all(torch.isfinite(p).all() for p in model.parameters())
    faults.configure({"watchdog": {"times": 99}})
    with pytest.raises(RuntimeError, match="diverged.*rollback"):
        tasync.train_async(_toy_step, TOY_PCFG, TOY_PPO, st0, st0,
                           n_envs=TN, horizon=TT, episodes=2, device="cpu",
                           watchdog=WatchdogConfig(max_rollbacks=1))


@pytest.mark.parametrize("plan,io", [((60, 60, 1), 1.2e6), ((7, 7, 1), 0.0),
                                     ((8, 4, 2), None), ((1, 1, 1), None)])
def test_async_speedup_matches_reference(plan, io):
    jm, tm = jsm.calibrate_to_paper(), tsm.calibrate_to_paper()
    for n_episodes in (100, 3000):
        ref = jasync.async_speedup(jm, jplan.ParallelPlan(*plan), n_episodes,
                                   io)
        out = tasync.async_speedup(tm, tplan.ParallelPlan(*plan),
                                   n_episodes, io)
        assert set(out) == set(ref)
        for k in ref:
            assert abs(out[k] - ref[k]) <= 1e-9 * abs(ref[k]), (k, plan)
    assert out["speedup"] > 1.0


def _tiny_train(tmp_path, **kw):
    return TrainConfig(env=EnvConfig(grid=GridConfig(res=6, dt=0.012,
                                                     poisson_iters=30),
                                     steps_per_action=3,
                                     actions_per_episode=3,
                                     warmup_time=1.0),
                       ppo=PPOConfig(epochs=2, minibatches=2), n_envs=2,
                       episodes=1, seed=0, device="cpu",
                       ckpt_dir=str(tmp_path / "ck"), ckpt_every=1, **kw)


def test_train_records_its_plan(tmp_path):
    logs = []
    hist, _ = train(_tiny_train(tmp_path, plan=(1, 1)), log_fn=logs.append)
    assert len(hist["reward"]) == 1
    assert any("plan[explicit]: n_envs x n_ranks = 1 x 1" in m for m in logs)
    meta = ck.read_manifest(ck.latest_checkpoint(str(tmp_path / "ck"))
                            )["metadata"]
    assert meta["plan"] == {"n_envs": 1, "n_ranks": 1,
                            "backend": "reference", "n_processes": 1}
    # resuming the plan's run without a plan: a note, not an error
    notes = ts_mod.check_resume_compatible(
        meta, {**meta, "plan": {"n_envs": 2, "n_ranks": 1,
                                "backend": "single-host"}})
    assert any(n.startswith("cross-plan resume") for n in notes)


@pytest.mark.parametrize("plan,error,match", [
    ((2, 1), ValueError, "devices but this host has 1"),
    # a halo plan on one device: its 2 workers need 2 devices, as the
    # reference's mesh says
    ((1, 2), ValueError, "devices but this host has 1"),
    # a fleet plan outside a fleet: its 2 workers need 2 devices, as in
    # the reference
    (tplan.ParallelPlan(2, 2, 1, 2), ValueError,
     "devices but this host has 1")])
def test_train_refuses_plans_it_cannot_run(tmp_path, plan, error, match):
    with pytest.raises(error, match=match):
        train(_tiny_train(tmp_path, plan=plan), log_fn=None)
