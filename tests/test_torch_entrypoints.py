"""The port's user-facing scripts on the CPU, each run once through its
``main(argv)`` with ``--device cpu`` at a small size (res 6, 2 envs, 3
actions of 5 dt, 2 episodes), and ``CylinderEnv.warmup(verbose=)``:

- ``drl_cylinder`` against the reference's ``examples/drl_cylinder.py`` at
  the same seed: the reference script runs as it is, and the port's gets
  the reference's initial params, rollout noise and PPO permutations
  (re-derived from seed 0 by the reference's own key splits), so the two
  runs' per-episode returns agree within ``test_torch_train``'s 1e-3;
- ``serve_batch`` from the port checkpoint that run wrote;
- ``hybrid_scaling_demo`` in paper mode against the reference's planner,
  and in ``--auto`` mode, its artifact validated by both packages."""
import contextlib
import io
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.cfd.env import CylinderEnv as JCylinderEnv
from repro.cfd.env import EnvConfig as JEnvConfig
from repro.cfd.grid import GridConfig as JGridConfig
from repro.core import autotune as jat
from repro.core.plan import optimize_plan as joptimize_plan
from repro.core.scaling_model import calibrate_to_paper as jcalibrate
from repro.drl import networks as jnet
from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import autotune as tat
from repro_torch.examples import drl_cylinder, hybrid_scaling_demo, \
    serve_batch
from tests import _torch_parity  # noqa: F401  (one thread, TF32 off)

ROOT = Path(__file__).resolve().parent.parent
N_ENVS, EPISODES, ACTIONS, EPOCHS = 2, 2, 3, 6
SCRIPT = ["--episodes", str(EPISODES), "--n-envs", str(N_ENVS), "--res", "6",
          "--actions", str(ACTIONS), "--steps-per-action", "5",
          "--warmup", "1.0"]
# test_torch_train's per-episode tolerance, for its reasons: flows ~1e-4
# apart, probes ~8e-4, the first update's ~2e-4 param differences carried
# into the second episode's rollout
ATOL_EPISODE = 1e-3


def _captured(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _reference_streams():
    """The reference script's initial params and per-episode rollout noise
    (N, T, 1) and epoch permutations (epochs, N*T), from seed 0 through
    RolloutEngine.init / run_sync / rollout_batch / ppo_update's splits."""
    key = jax.random.PRNGKey(0)
    key, kp = jax.random.split(key)
    params = jnet.init_actor_critic(jnet.PolicyConfig(obs_dim=149), kp)
    noise, perms = [], []
    for _ in range(EPISODES):
        key, kr, ku = jax.random.split(key, 3)
        noise.append(np.stack([
            np.stack([np.asarray(jax.random.normal(k, (1,)))
                      for k in jax.random.split(ke, ACTIONS)])
            for ke in jax.random.split(kr, N_ENVS)]))
        perms.append(np.stack([
            np.asarray(jax.random.permutation(k, N_ENVS * ACTIONS))
            for k in jax.random.split(ku, EPOCHS)]))
    return jax.tree.map(np.asarray, params), noise, perms


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    argv = sys.argv
    sys.argv = ["drl_cylinder.py", *SCRIPT, "--out", str(d / "ref.json")]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_path(str(ROOT / "examples" / "drl_cylinder.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
    params0, noise, perms = _reference_streams()
    hist, log = _captured(
        drl_cylinder.main,
        [*SCRIPT, "--device", "cpu", "--ckpt-dir", str(d / "ckpt"),
         "--ckpt-every", "1", "--sink", f"binary:{d / 'spill'}",
         "--out", str(d / "port.json")],
        model=params_from_jax(params0, device="cpu"), noise=noise,
        perms=perms)
    return dict(dir=d, hist=hist, log=log,
                ref=json.loads((d / "ref.json").read_text()),
                port=json.loads((d / "port.json").read_text()))


def test_drl_cylinder_returns_match_the_reference_script(runs):
    ref, port = runs["ref"], runs["port"]
    assert set(port) == set(ref)
    assert len(port["reward"]) == len(ref["reward"]) == EPISODES
    err = np.max(np.abs(np.asarray(port["reward"])
                        - np.asarray(ref["reward"])))
    assert err <= ATOL_EPISODE, (port["reward"], ref["reward"])
    np.testing.assert_array_equal(runs["hist"]["reward"], port["reward"])


def test_drl_cylinder_reports_like_the_reference(runs):
    log = runs["log"]
    assert "return: " in log and "tail CD: " in log
    assert f"sink[binary]: {EPISODES} episodes" in log
    assert sorted(p.name for p in (runs["dir"] / "spill").glob("*.bin")) == \
        ["traj_000000.bin", "traj_000001.bin"]


def test_drl_cylinder_lists_scenarios():
    from repro_torch.cfd.scenarios import list_scenarios
    out, log = _captured(drl_cylinder.main, ["--list-scenarios"])
    assert out is None
    assert [ln.split()[0] for ln in log.splitlines()] == \
        list(list_scenarios())


def test_serve_batch_from_the_port_checkpoint(runs):
    res, log = _captured(serve_batch.main, [
        "--device", "cpu", "--ckpt", str(runs["dir"] / "ckpt"),
        "--batch", "8", "--requests", "20", "--deterministic"])
    assert f"(episode {EPISODES})" in log and log.rstrip().endswith("OK")
    assert res["act_shape"] == [8, 1]
    assert 0 < res["p50_s"] <= res["p99_s"] and res["actions_per_s"] > 0


def test_serve_batch_fresh_params():
    res, log = _captured(serve_batch.main, [
        "--device", "cpu", "--batch", "4", "--requests", "5"])
    assert "fresh params" in log and res["act_shape"] == [4, 1]


def test_hybrid_demo_paper_mode_matches_the_reference():
    best, log = _captured(hybrid_scaling_demo.main, ["--workers", "60"])
    ref = joptimize_plan(60, jcalibrate(), 3000, 5.0e6)
    assert (best.n_envs, best.n_ranks) == (ref.n_envs, ref.n_ranks) == (60, 1)
    assert "paper: 60 x 1: matches" in log


def test_hybrid_demo_auto_mode(tmp_path):
    art = tmp_path / "demo.json"
    (best, rp), log = _captured(hybrid_scaling_demo.main, [
        "--auto", "--smoke", "--device", "cpu", "--artifact", str(art)])
    assert (best.n_envs, best.n_ranks) == (1, 1)
    assert rp.source == "auto" and "plan[auto]" in log
    rec = json.loads(art.read_text())
    tat.validate_artifact(rec)
    jat.validate_artifact(rec)


def test_warmup_verbose_prints_the_reference_line():
    """``warmup(verbose=True)``, which raised TypeError before, prints the
    reference's line: the same dt count and C_D0 within the golden
    tolerance of the two flows (~1e-4 apart)."""
    kw = dict(steps_per_action=5, actions_per_episode=3, warmup_time=1.0)
    env = CylinderEnv(EnvConfig(grid=GridConfig(res=6), **kw), device="cpu")
    _, log = _captured(env.warmup, verbose=True)
    jenv = JCylinderEnv(JEnvConfig(grid=JGridConfig(res=6), **kw))
    _, jlog = _captured(jenv.warmup, verbose=True)
    ours, ref = log.strip().split(), jlog.strip().split()
    n = round(1.0 / GridConfig(res=6).dt)
    assert ours[:3] == ref[:3] == ["warmup", str(n), "steps:"]
    assert abs(float(ours[3].split("=")[1])
               - float(ref[3].split("=")[1])) <= 1e-3
    # cached: a second call prints again without re-running the warmup
    _, again = _captured(env.warmup, verbose=True)
    assert again == log
