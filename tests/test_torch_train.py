"""End-to-end gate of the port's training loop against the reference: a
2-episode train at res 6 (the verify recipe's sizes) with the reference's
initial params, rollout noise and PPO permutations injected.

Both runs record the PPO batch of every episode (the reference through
its CFD<->DRL interface hook, the port by wrapping ``ppo_update``), so
the wiring of ``train()`` is checked in two halves:

- collect -> values -> GAE -> flatten: the port's first batch against
  the reference's, field by field, in the same sample order;
- the updates: the reference's ``ppo_update``, fed the port's own batches
  with the reference's episode keys, starting from the same params and
  carrying its optimizer state and step across episodes, against the
  params the port's ``train()`` left after each update.

The trained params themselves are not compared with the reference's:
the float32 flows of the two runs differ by ~1e-4, the 40 single-sample
Adam steps of an update amplify that to ~2e-4 in the critic, and episode
2's advantages come from that critic, so the second update starts from
batches ~1e-2 apart."""
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

N_ENVS, EPISODES, SEED = 2, 2, 0
ENV_KW = dict(steps_per_action=5, actions_per_episode=3, warmup_time=1.0)


def _reference_streams(n_samples, epochs):
    """The reference run's initial params and, per episode, its rollout
    noise (N, T, 1), epoch permutations (epochs, N*T) and update key,
    re-derived from the same key splits as RolloutEngine.init / run_sync /
    rollout_batch / ppo_update."""
    T = ENV_KW["actions_per_episode"]
    key = jax.random.PRNGKey(SEED)
    key, kp = jax.random.split(key)
    params = jnet.init_actor_critic(jnet.PolicyConfig(obs_dim=149), kp)
    noise, perms, update_keys = [], [], []
    for _ in range(EPISODES):
        key, kr, ku = jax.random.split(key, 3)
        noise.append(np.stack([
            np.stack([np.asarray(jax.random.normal(k, (1,)))
                      for k in jax.random.split(ke, T)])
            for ke in jax.random.split(kr, N_ENVS)]))
        perms.append(np.stack([
            np.asarray(jax.random.permutation(k, n_samples))
            for k in jax.random.split(ku, epochs)]))
        update_keys.append(ku)
    return jax.tree.map(np.asarray, params), noise, perms, update_keys


class _BatchRecorder:
    """The reference's CFD<->DRL interface hook, recording each batch."""

    def __init__(self):
        self.batches = []

    def exchange(self, batch):
        self.batches.append(jax.tree.map(np.asarray, batch))
        return batch


@pytest.fixture(scope="module")
def runs():
    recorder = _BatchRecorder()
    ref_hist, ref_params = jtrain.train(
        jtrain.TrainConfig(env=JEnvConfig(grid=JGridConfig(res=6), **ENV_KW),
                           n_envs=N_ENVS, episodes=EPISODES, seed=SEED),
        log_fn=None, interface=recorder)
    cfg = ttrain.TrainConfig(env=EnvConfig(grid=GridConfig(res=6), **ENV_KW),
                             n_envs=N_ENVS, episodes=EPISODES, seed=SEED,
                             device="cpu")
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
    return dict(ref_hist=ref_hist, ref_params=jax.tree.map(np.asarray,
                                                           ref_params),
                ref_batches=recorder.batches, hist=hist, model=model,
                batches=batches, updated=updated, params0=params0,
                update_keys=update_keys)


# Per-episode reward and tail C_D are O(1-5).  The flow differs from the
# reference at ~1e-4 after the warmup (float32 rounding order, see
# test_torch_solver), the probe observations (O(2.5)) at ~8e-4 and the
# actions at ~1e-4; episode 2 also carries the first update's ~2e-4 param
# differences through the rollout -> 1e-3 absolute.
ATOL_EPISODE = 1e-3

# The first PPO batch, field by field (same flows as above): observations
# O(2.5) -> 2e-3; actions O(1) and advantages/returns O(1), both fed by
# the probes -> 1e-3; log-probs follow from the injected noise alone
# (act - mean = std * eps) -> 1e-5; probe coordinates are geometry ->
# 1e-6; the probe mask and the validity mask are exact.
ATOL_BATCH = {"obs": 2e-3, "act": 1e-3, "logp_old": 1e-5, "adv": 1e-3,
              "ret": 1e-3, "probe_xy": 1e-6, "probe_mask": 0.0,
              "valid": 0.0}

# The same batches through both updates: 40 Adam steps of float32
# gradients that differ in the last bits (~4e-7 measured after one
# update, params moving by ~1e-2) -> 1e-5.
ATOL_UPDATE = 1e-5


def test_history_keys_match(runs):
    assert set(runs["hist"]) == set(runs["ref_hist"])
    assert all(len(v) == EPISODES for v in runs["hist"].values())


@pytest.mark.parametrize("field", ["reward", "cd", "cl"])
def test_per_episode_metrics_match(runs, field):
    ref_hist, hist = runs["ref_hist"], runs["hist"]
    assert max_diff(ref_hist[field], hist[field])[0] <= ATOL_EPISODE, \
        (ref_hist[field], hist[field])


@pytest.mark.parametrize("field", sorted(ATOL_BATCH))
def test_first_batch_matches_reference(runs, field):
    """collect -> values -> GAE -> flatten: the first batch train() hands
    to PPO equals the reference's, sample for sample (the env-major
    flatten order included)."""
    assert len(runs["batches"]) == len(runs["ref_batches"]) == EPISODES
    ref = getattr(runs["ref_batches"][0], field)
    out = getattr(runs["batches"][0], field)
    assert ref is not None and out is not None, field
    assert max_diff(ref, out)[0] <= ATOL_BATCH[field], field


def test_updates_match_reference_on_the_same_batches(runs):
    """train()'s update wiring: episode e's permutations, the optimizer
    state and the Adam step carried across episodes.  The reference's
    update replays the port's batches from the same params; every param
    (actor, critic, log_std) is held to ATOL_UPDATE after each update."""
    ppo_cfg = jppo.PPOConfig()
    optimizer = jppo.make_optimizer(ppo_cfg)
    params = jax.tree.map(jnp.asarray, runs["params0"])
    opt_state, step = optimizer.init(params), jnp.int32(0)
    moved = 0.0
    for e in range(EPISODES):
        batch = jppo.Batch(*(None if x is None else jnp.asarray(x)
                             for x in runs["batches"][e]))
        params, opt_state, step, _ = jppo.ppo_update(
            ppo_cfg, optimizer, params, opt_state, batch,
            runs["update_keys"][e], step)
        ref, out = jax.tree.map(np.asarray, params), runs["updated"][e]
        for side in ("actor", "critic"):
            for a, o in zip(ref[side], out[side]):
                for k in ("w", "b"):
                    assert max_diff(a[k], o[k])[0] <= ATOL_UPDATE, \
                        (e, side, k)
        assert max_diff(ref["log_std"], out["log_std"])[0] <= ATOL_UPDATE
        moved = max(moved, max_diff(runs["params0"]["critic"][0]["w"],
                                    out["critic"][0]["w"])[0])
    assert moved > 1e-3                      # the updates did move params
    final = params_to_numpy(runs["model"])
    assert max_diff(runs["updated"][-1]["log_std"], final["log_std"])[0] == 0


def test_params_finite_and_actor_unchanged(runs):
    """Params are finite, and the actor is exactly where it started in
    both runs: 3 actions x 2 envs = 6 samples split into 4 minibatches
    of one sample, whose normalized advantage (adv - mean) / std is
    exactly 0, so the clipped surrogate gives the actor no gradient.  The
    critic and log_std do move; they are held against the reference in
    test_updates_match_reference_on_the_same_batches."""
    ref_params, model = runs["ref_params"], runs["model"]
    out = params_to_numpy(model)
    for p in model.parameters():
        assert torch.isfinite(p).all()
    for a, o, z in zip(ref_params["actor"], out["actor"],
                       runs["params0"]["actor"]):
        assert max_diff(a["w"], o["w"])[0] <= 1e-6
        assert max_diff(z["w"], o["w"])[0] == 0


def test_health_counters_zero(runs):
    hist = runs["hist"]
    assert hist["quarantines"].tolist() == [0.0] * EPISODES
    assert hist["grad_skips"].tolist() == [0.0] * EPISODES
