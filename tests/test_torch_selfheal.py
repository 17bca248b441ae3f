"""Self-healing training in the port: every recovery path driven by the
port's own fault injector (``repro_torch.testing.faults``), as
tests/test_selfheal.py drives the reference's.

Layers, cheapest first: the injector, ``retry_io`` and the watchdog on the
host; the ``grad_nan`` skip in ``ppo_update``; the ``nan_env`` quarantine
on a real env batch at res 6 (the poisoned env reset from its warmup flow,
the others' step bit-equal to a clean one); then ``train()``: one
quarantine per episode, one skipped update, a watchdog rollback that
completes and matches the run without the fault bit for bit, and an
exhausted rollback budget raising the actionable error.  No tolerance:
every comparison here is exact."""
import json

import numpy as np
import pytest
import torch

from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.ckpt import checkpoint as ck
from repro_torch.ckpt.io import retry_io
from repro_torch.drl import networks
from repro_torch.drl.health import Watchdog, WatchdogConfig
from repro_torch.drl.ppo import Batch, PPOConfig, make_optimizer, ppo_update
from repro_torch.drl.train import TrainConfig, train
from repro_torch.testing import faults
from tests import _torch_parity  # noqa: F401  (one thread, TF32 off)

ENV = EnvConfig(grid=GridConfig(res=6, dt=0.012, poisson_iters=30),
                steps_per_action=3, actions_per_episode=3, warmup_time=1.0)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()      # a test that armed faults must not leak them


def _cfg(episodes, ckpt_dir=None, **kw):
    return TrainConfig(env=ENV, ppo=PPOConfig(epochs=2, minibatches=2),
                       n_envs=2, episodes=episodes, seed=0,
                       ckpt_dir=ckpt_dir, ckpt_every=1, device="cpu", **kw)


def _assert_models_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# fault injector, retry_io, watchdog (host side)
# ---------------------------------------------------------------------------

def test_faults_configure_and_consume():
    faults.configure({"watchdog": {"episode": 3}})
    assert faults.active("watchdog") == {"episode": 3}
    assert faults.active("nan_env") is None
    assert not faults.consume("watchdog", episode=2)   # mismatch: not eaten
    assert faults.active("watchdog") is not None
    assert faults.consume("watchdog", episode=3)
    assert faults.active("watchdog") is None           # one-shot: consumed
    assert not faults.consume("watchdog", episode=3)


def test_faults_times_counter():
    faults.configure({"sink_oserror": {"times": 2}})
    assert faults.consume("sink_oserror")
    assert faults.consume("sink_oserror")
    assert not faults.consume("sink_oserror")


def test_faults_missing_keys_match_anything():
    faults.configure({"watchdog": {}})
    assert faults.consume("watchdog", episode=42)


def test_faults_env_var(monkeypatch):
    monkeypatch.setenv(faults.ENV_FAULTS,
                       json.dumps({"grad_nan": {"step": 7}}))
    faults.reset()                       # re-arm environment loading
    assert faults.active("grad_nan") == {"step": 7}
    monkeypatch.setenv(faults.ENV_FAULTS, "not json")
    faults.reset()
    with pytest.raises(ValueError, match="not valid JSON"):
        faults.active("grad_nan")
    monkeypatch.setenv(faults.ENV_FAULTS, "[1, 2]")
    faults.reset()
    with pytest.raises(ValueError, match="JSON object"):
        faults.active("grad_nan")


def test_faults_match_the_reference_kinds():
    """The same REPRO_FAULTS spec drives both packages."""
    from repro.testing import faults as jfaults
    assert faults.ENV_FAULTS == jfaults.ENV_FAULTS
    spec = {"nan_env": {"env": 1, "step": 4}, "ckpt_crash": {"step": 2}}
    faults.configure(spec)
    jfaults.configure(spec)
    try:
        for kind in ("nan_env", "grad_nan", "watchdog", "ckpt_crash"):
            assert faults.active(kind) == jfaults.active(kind)
        with pytest.raises(OSError, match="injected ckpt_crash"):
            faults.maybe_crash_ckpt(2, "x")
    finally:
        jfaults.reset()


def test_retry_io_recovers_then_exhausts(tmp_path):
    calls, sleeps, retries = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("disk hiccup")
        return "ok"

    out = retry_io(flaky, path=tmp_path / "f", sleep=sleeps.append,
                   on_retry=lambda n, e: retries.append(n))
    assert out == "ok" and len(calls) == 3
    assert sleeps == [0.05, 0.1]         # exponential backoff
    assert retries == [1, 2]
    with pytest.raises(OSError, match="after 4 attempts"):
        retry_io(lambda: (_ for _ in ()).throw(OSError("dead")),
                 path=tmp_path / "g", sleep=lambda s: None)


def _metrics(**kw):
    base = {"policy_loss": 0.1, "value_loss": 1.0, "grad_norm": 0.5,
            "approx_kl": 0.01}
    base.update(kw)
    return base


def test_watchdog_nonfinite_and_kl_trip():
    wd = Watchdog()
    assert wd.observe(_metrics(), episode=0) is None
    assert "non-finite" in wd.observe(_metrics(value_loss=float("nan")),
                                      episode=1)
    assert "approx_kl" in wd.observe(_metrics(approx_kl=99.0), episode=2)


def test_watchdog_spike_needs_full_window():
    wd = Watchdog(WatchdogConfig(window=3, spike_factor=10.0))
    # window not full: a huge value is NOT a spike yet (no baseline)
    assert wd.observe(_metrics(value_loss=500.0), episode=0) is None
    for ep in (1, 2):
        assert wd.observe(_metrics(), episode=ep) is None
    reason = wd.observe(_metrics(value_loss=1e5), episode=3)
    assert reason is not None and "spiked" in reason
    # the anomalous episode was not folded into the baseline
    assert wd.observe(_metrics(), episode=4) is None


def test_watchdog_injected_fault():
    faults.configure({"watchdog": {"episode": 1}})
    wd = Watchdog()
    assert wd.observe(_metrics(), episode=0) is None
    assert wd.observe(_metrics(), episode=1) == "injected watchdog fault"
    assert wd.observe(_metrics(), episode=1) is None   # consumed


# ---------------------------------------------------------------------------
# grad_nan: the poisoned update is rejected whole
# ---------------------------------------------------------------------------

def _toy_batch(n=8):
    g = torch.Generator().manual_seed(3)
    return Batch(obs=torch.randn(n, 3, generator=g),
                 act=torch.randn(n, 1, generator=g),
                 logp_old=torch.randn(n, generator=g),
                 adv=torch.randn(n, generator=g),
                 ret=torch.randn(n, generator=g))


def test_grad_skip_rejects_poisoned_update():
    """epochs=1/minibatches=1: the single update IS the poisoned one.
    Params and moments stay bitwise untouched, the skip is counted, the
    reported grad_norm is 0 and the step advances anyway."""
    cfg = PPOConfig(epochs=1, minibatches=1)
    model = networks.init_actor_critic(
        networks.PolicyConfig(obs_dim=3, act_dim=1, hidden=16),
        torch.Generator().manual_seed(0), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = make_optimizer(cfg)
    opt_state = optimizer.init(list(model.parameters()))
    perms = [np.arange(8)]

    faults.configure({"grad_nan": {"step": 0}})
    o1, step1, m1 = ppo_update(cfg, optimizer, model, opt_state,
                               _toy_batch(), 0, perms=perms)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(o1[k], opt_state[k]))
    assert step1 == 1
    assert float(m1["grad_skips"]) == 1.0
    assert float(m1["grad_norm"]) == 0.0

    faults.reset()
    _, _, m2 = ppo_update(cfg, optimizer, model, opt_state, _toy_batch(), 0,
                          perms=perms)
    assert float(m2["grad_skips"]) == 0.0 and float(m2["grad_norm"]) > 0.0
    assert any(not torch.equal(v, before[k])
               for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# nan_env: the sentinel quarantines the poisoned env, and only it
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env_batch():
    env = CylinderEnv(ENV, device="cpu")
    st_b, obs_b = env.reset_batch(["cyl_re100"], n_envs=3)
    return env, st_b


def test_nan_env_quarantines_only_the_poisoned_env(env_batch):
    env, st0 = env_batch
    acts = torch.tensor([0.3, -0.2, 0.1])
    clean = [env.env_step(st0, acts)]
    clean.append(env.env_step(clean[0][0], acts))
    faults.configure({"nan_env": {"env": 1, "step": 1}})
    st1, out = env.env_step(st0, acts)                  # t=0: healthy
    assert torch.equal(out.valid, torch.ones(3))
    st2, out = env.env_step(st1, acts)                  # t=1: env 1 poisoned
    assert torch.equal(out.valid, torch.tensor([1.0, 0.0, 1.0]))
    assert float(out.reward[1]) == 0.0 and float(out.cd[1]) == 0.0
    # the quarantined env is reset from its warmup flow, bit for bit
    for got, ref in zip(st2.flow, st2.reset_flow):
        assert torch.equal(got[1], ref[1])
    assert float(st2.jet_vel[1]) == 0.0
    # the other envs stepped exactly as without the fault
    cst, cout = clean[1]
    for got, ref in zip(st2.flow, cst.flow):
        assert torch.equal(got[[0, 2]], ref[[0, 2]])
    assert torch.equal(out.obs[[0, 2]], cout.obs[[0, 2]])
    assert torch.equal(out.reward[[0, 2]], cout.reward[[0, 2]])
    _, out = env.env_step(st2, acts)                    # t=2: healed
    assert torch.equal(out.valid, torch.ones(3))
    assert torch.isfinite(out.reward).all()


def test_nan_env_one_quarantine_per_episode():
    faults.configure({"nan_env": {"env": 1, "step": 1}})
    health = {}
    hist, model = train(_cfg(2), log_fn=None, health=health)
    np.testing.assert_array_equal(hist["quarantines"], [1.0, 1.0])
    assert health["quarantines"] == 2 and health["grad_skips"] == 0
    assert np.isfinite(hist["reward"]).all()
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_grad_nan_skips_one_update():
    faults.configure({"grad_nan": {"step": 5}})
    health = {}
    hist, model = train(_cfg(2), log_fn=None, health=health)
    np.testing.assert_array_equal(hist["grad_skips"], [0.0, 1.0])
    assert health["grad_skips"] == 1 and health["quarantines"] == 0
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# train(): watchdog rollback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clean_run():
    return train(_cfg(2), log_fn=None)


def test_watchdog_trip_rolls_back_and_completes(tmp_path, clean_run):
    """The tripped episode is never saved; the replay from the episode-1
    checkpoint ends where the run without the fault ends, bit for bit."""
    d = str(tmp_path / "rb")
    faults.configure({"watchdog": {"episode": 1}})
    logs, health = [], {}
    hist, model = train(_cfg(2, d), log_fn=logs.append, health=health)
    assert any("rolling back" in line for line in logs), logs
    assert any("resume:" in line for line in logs), logs
    assert len(hist["reward"]) == 2
    assert health["rollbacks"] == 1
    meta = ck.read_manifest(ck.latest_checkpoint(d))["metadata"]
    assert meta["health"]["rollbacks"] == 1
    ref_hist, ref_model = clean_run
    _assert_models_equal(model, ref_model)
    for f in ("reward", "cd", "cl"):
        np.testing.assert_array_equal(hist[f], ref_hist[f])


def test_watchdog_without_ckpt_dir_restarts_fresh(clean_run):
    faults.configure({"watchdog": {"episode": 1}})
    health = {}
    hist, model = train(_cfg(2), log_fn=None, health=health)
    assert health["rollbacks"] == 1 and len(hist["reward"]) == 2
    _assert_models_equal(model, clean_run[1])


def test_watchdog_exhausts_rollbacks_actionable():
    # a fault that trips every attempt: the bounded retries exhaust and the
    # error says what to do about it
    faults.configure({"watchdog": {"times": 99}})
    with pytest.raises(RuntimeError, match="diverged.*rollback"):
        train(_cfg(1, watchdog=WatchdogConfig(max_rollbacks=1)),
              log_fn=None)
