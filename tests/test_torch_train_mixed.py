"""End-to-end gate of mixed-scenario training against the reference:
``train(scenarios=("cyl_re100", "pinball_re100"), n_envs=2)`` at res 6,
one policy over a cylinder (jets, 149 probes) and a fluidic pinball
(three rotating bodies, 59 probes padded to 149), actions of width 3.

The harness is test_torch_train.py's: the reference's initial params,
rollout noise (N, T, 3) and PPO permutations injected into the port's
``train()``, the first PPO batch held field by field and the updates
replayed through the reference's ``ppo_update`` on the port's batches.

Tolerances: the cylinder env's samples are held to that file's.  The
pinball's are held to them times PINBALL_SCALE: its rewards are
differences of drags ~5.4x the cylinder's (C_D0 26.04 against 4.81 on this
grid and warmup), and float32 rounding in another order per package
leaves its flow ~1e-5 of those drags apart, so its probes, rewards,
advantages and returns differ ~5x as much (measured: obs 3.2e-3, returns
2.9e-3, the cylinder's 8.1e-4 and 1.9e-4).  The history averages both
envs and the first update sees both, so they take the same factor.  Only
the first update is replayed: on inputs of the pinball's size one update
moves a critic weight by ~2e-4 for a 1e-6 relative change of the
observations, where O(1) inputs move it by ~3e-7, so the second update,
which starts from params ~3e-5 apart, ends ~2e-3 apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd.env import EnvConfig as JEnvConfig
from repro.cfd.grid import GridConfig as JGridConfig
from repro.drl import networks as jnet
from repro.drl import ppo as jppo
from repro.drl import train as jtrain
from repro_torch.cfd.env import EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.drl import engine as tengine
from repro_torch.drl import train as ttrain
from repro_torch.drl.ppo import Batch
from tests._torch_parity import max_diff
from tests.test_torch_train import (ATOL_BATCH, ATOL_EPISODE, ATOL_UPDATE,
                                    ENV_KW, EPISODES, N_ENVS, SEED,
                                    _BatchRecorder)

SCENARIOS = ("cyl_re100", "pinball_re100")
OBS_DIM, ACT_DIM = 149, 3
T = ENV_KW["actions_per_episode"]
PINBALL_SCALE = 6.0


def _reference_streams(n_samples, epochs):
    """The reference run's initial params and, per episode, its rollout
    noise (N, T, ACT_DIM), epoch permutations and update key, from the
    same key splits as its RolloutEngine.init / run_sync / rollout_batch /
    ppo_update."""
    key = jax.random.PRNGKey(SEED)
    key, kp = jax.random.split(key)
    params = jnet.init_actor_critic(
        jnet.PolicyConfig(obs_dim=OBS_DIM, act_dim=ACT_DIM), kp)
    noise, perms, update_keys = [], [], []
    for _ in range(EPISODES):
        key, kr, ku = jax.random.split(key, 3)
        noise.append(np.stack([
            np.stack([np.asarray(jax.random.normal(k, (ACT_DIM,)))
                      for k in jax.random.split(ke, T)])
            for ke in jax.random.split(kr, N_ENVS)]))
        perms.append(np.stack([
            np.asarray(jax.random.permutation(k, n_samples))
            for k in jax.random.split(ku, epochs)]))
        update_keys.append(ku)
    return jax.tree.map(np.asarray, params), noise, perms, update_keys


@pytest.fixture(scope="module")
def runs():
    recorder = _BatchRecorder()
    ref_hist, _ = jtrain.train(
        jtrain.TrainConfig(env=JEnvConfig(grid=JGridConfig(res=6), **ENV_KW),
                           n_envs=N_ENVS, episodes=EPISODES, seed=SEED,
                           scenarios=SCENARIOS),
        log_fn=None, interface=recorder)
    cfg = ttrain.TrainConfig(env=EnvConfig(grid=GridConfig(res=6), **ENV_KW),
                             n_envs=N_ENVS, episodes=EPISODES, seed=SEED,
                             scenarios=SCENARIOS, device="cpu")
    params0, noise, perms, update_keys = _reference_streams(
        N_ENVS * ENV_KW["actions_per_episode"], cfg.ppo.epochs)

    batches, updated = [], []
    ppo_update = tengine.ppo_update

    def recording_update(ppo_cfg, optimizer, model, opt_state, batch, step,
                         **kw):
        batches.append(Batch(*(None if x is None else x.detach().numpy()
                               for x in batch)))
        out = ppo_update(ppo_cfg, optimizer, model, opt_state, batch, step,
                         **kw)
        updated.append(params_to_numpy(model))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "ppo_update", recording_update)
        hist, model = ttrain.train(
            cfg, log_fn=None, model=params_from_jax(params0, device="cpu"),
            noise=noise, perms=perms)
    return dict(ref_hist=ref_hist, ref_batches=recorder.batches, hist=hist,
                model=model, batches=batches, updated=updated,
                params0=params0, update_keys=update_keys)


def test_policy_widths_follow_the_mixed_batch(runs):
    model = runs["model"]
    assert model.actor[0].weight.shape[1] == OBS_DIM
    assert model.actor[-1].weight.shape[0] == ACT_DIM
    assert runs["batches"][0].act.shape == (N_ENVS * ENV_KW[
        "actions_per_episode"], ACT_DIM)
    assert all(len(v) == EPISODES for v in runs["hist"].values())
    assert set(runs["hist"]) == set(runs["ref_hist"])


@pytest.mark.parametrize("field", ["reward", "cd", "cl"])
def test_per_episode_metrics_match(runs, field):
    ref_hist, hist = runs["ref_hist"], runs["hist"]
    assert max_diff(ref_hist[field], hist[field])[0] <= (
        ATOL_EPISODE * PINBALL_SCALE), (ref_hist[field], hist[field])


@pytest.mark.parametrize("field", sorted(ATOL_BATCH))
def test_first_batch_matches_reference(runs, field):
    """collect -> values -> GAE -> flatten on the mixed batch: the first
    batch train() hands to PPO equals the reference's, sample for sample
    (the padded probe slots and the masked action slots included); the
    env-major flatten puts the cylinder's T samples first."""
    assert len(runs["batches"]) == len(runs["ref_batches"]) == EPISODES
    ref = getattr(runs["ref_batches"][0], field)
    out = getattr(runs["batches"][0], field)
    assert ref is not None and out is not None, field
    assert max_diff(ref[:T], out[:T])[0] <= ATOL_BATCH[field], field
    assert max_diff(ref[T:], out[T:])[0] <= (
        ATOL_BATCH[field] * PINBALL_SCALE), field


def test_updates_match_reference_on_the_same_batches(runs):
    """The reference's update replays the port's first batch from the same
    params; every param is held after it, and the params moved."""
    ppo_cfg = jppo.PPOConfig()
    optimizer = jppo.make_optimizer(ppo_cfg)
    params = jax.tree.map(jnp.asarray, runs["params0"])
    batch = jppo.Batch(*(None if x is None else jnp.asarray(x)
                         for x in runs["batches"][0]))
    params, _, _, _ = jppo.ppo_update(
        ppo_cfg, optimizer, params, optimizer.init(params), batch,
        runs["update_keys"][0], jnp.int32(0))
    ref, out = jax.tree.map(np.asarray, params), runs["updated"][0]
    for side in ("actor", "critic"):
        for a, o in zip(ref[side], out[side]):
            for k in ("w", "b"):
                assert max_diff(a[k], o[k])[0] <= (
                    ATOL_UPDATE * PINBALL_SCALE), (side, k)
    assert max_diff(ref["log_std"], out["log_std"])[0] <= (
        ATOL_UPDATE * PINBALL_SCALE)
    assert max_diff(runs["params0"]["critic"][0]["w"],
                    out["critic"][0]["w"])[0] > 1e-3
    for p in runs["model"].parameters():
        assert torch.isfinite(p).all()
