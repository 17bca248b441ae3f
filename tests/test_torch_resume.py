"""Checkpoints and bitwise resume in the port, torch against torch; the
values of a reference checkpoint against the port's carry of them.

Layers, cheapest first:
  * the checkpoint format (JSON manifest, zlib, per-leaf crc32): round
    trips of every dtype the state holds, damaged files raising, the
    background writer's snapshot isolated from in-place updates;
  * the two packages refuse each other's files: the port's loader names a
    reference checkpoint and points at ``convert.train_state_from_numpy``,
    the reference's ``validate`` refuses the port's magic;
  * ``train()``: ``train(episodes=1)`` then a resume to 2 equals
    ``train(episodes=2)`` bit for bit (params, Adam moments, generator
    state, PPO step, env batch, history) for the MLP and for the attention
    policy on a mixed cylinder + pinball batch; the resume runs no warmup;
    ``resume="auto"`` on an empty dir is a fresh run; a crashed write's
    ``.tmp`` is skipped; strict-field, policy, framework and geometry-bank
    mismatches raise ``CheckpointError``;
  * a reference run's checkpoint tree carried through
    ``convert.train_state_from_numpy``, leaf by leaf exact, and resumed by
    the port."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cfd.env import CylinderEnv, EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.ckpt import checkpoint as ck
from repro_torch.convert import params_to_numpy, train_state_from_numpy
from repro_torch.drl import networks
from repro_torch.drl import train_state as ts_mod
from repro_torch.drl.ppo import PPOConfig
from repro_torch.drl.train import TrainConfig, train
from repro_torch.testing import faults
from tests import _torch_parity  # noqa: F401  (one thread, TF32 off)

GRID = dict(res=6, dt=0.012, poisson_iters=30)
ENV_KW = dict(steps_per_action=3, actions_per_episode=3, warmup_time=1.0)
MIXED = ("cyl_re100", "pinball_re100")


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def _cfg(episodes, ckpt_dir=None, **kw):
    return TrainConfig(env=EnvConfig(grid=GridConfig(**GRID), **ENV_KW),
                       ppo=PPOConfig(epochs=2, minibatches=2), n_envs=2,
                       episodes=episodes, seed=0, ckpt_dir=ckpt_dir,
                       ckpt_every=1, device="cpu", **kw)


def _assert_states_equal(a, b):
    """Two TrainStates, every leaf exact."""
    fa = ck._flatten_with_paths(ts_mod.to_tree(a))
    fb = ck._flatten_with_paths(ts_mod.to_tree(b))
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if k == "history/wall":          # wall-clock, not state
            continue
        x, y = ck.host_array(fa[k]), ck.host_array(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# ---------------------------------------------------------------------------
# the checkpoint format
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(0)
    return {"f": rng.standard_normal((3, 4)).astype(np.float32),
            "i": np.arange(5, dtype=np.int64), "u": np.arange(7, dtype=np.uint8),
            "scalar": np.asarray(3, np.int64), "empty": np.zeros((0, 2)),
            "t": torch.arange(6, dtype=torch.float32).reshape(2, 3).T,
            "nested": {"list": [np.float32(1.5), np.ones(2)]}, "none": None}


@pytest.mark.parametrize("compress", [False, True])
def test_roundtrip_preserves_paths_dtypes_and_bits(tmp_path, compress):
    p = str(tmp_path / "a.ckpt")
    ck.save(p, _tree(), step=3, compress=compress, metadata={"x": [1, "y"]})
    arrays, manifest = ck.restore(p)
    want = ck._flatten_with_paths(_tree())
    assert sorted(arrays) == sorted(want)      # the None leaf is dropped
    for k, v in want.items():
        a = ck.host_array(v)
        assert arrays[k].dtype == a.dtype and arrays[k].shape == a.shape, k
        np.testing.assert_array_equal(arrays[k], a)
    assert manifest["step"] == 3 and manifest["metadata"] == {"x": [1, "y"]}
    out = ck.restore(p, _tree())
    assert list(out) == list(want)
    with pytest.raises(ck.CheckpointError, match="dtype"):
        ck.restore(p, {**_tree(), "i": np.arange(5, dtype=np.int32)})
    with pytest.raises(ck.CheckpointError, match="missing"):
        ck.restore(p, {**_tree(), "extra": np.ones(1)})
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("compress", [False, True])
def test_damaged_files_raise_not_garbage(tmp_path, compress):
    p = tmp_path / "a.ckpt"
    ck.save(str(p), _tree(), compress=compress)
    raw = bytearray(p.read_bytes())
    cut = tmp_path / "cut.ckpt"
    cut.write_bytes(raw[:-5])
    with pytest.raises(ck.CheckpointError, match="truncated|corrupted"):
        ck.restore(str(cut))
    with pytest.raises(ck.CheckpointError, match="truncated|corrupted"):
        ck.validate(str(cut), deep=True)
    raw[-2] ^= 0xFF                      # flip bits in the last leaf
    flip = tmp_path / "flip.ckpt"
    flip.write_bytes(raw)
    with pytest.raises(ck.CheckpointError, match="crc32|decompress"):
        ck.validate(str(flip), deep=True)


def test_latest_checkpoint_skips_a_crashed_write(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": np.arange(4, dtype=np.float32)}
    p1 = ck.save_step(d, 1, tree)
    faults.configure({"ckpt_crash": {"step": 2}})
    with pytest.raises(OSError, match="injected ckpt_crash"):
        ck.save_step(d, 2, tree)
    # the torn write left a .tmp but no destination: resume falls back
    assert (tmp_path / "ck" / "step_00000002.ckpt.tmp").exists()
    assert not ck.step_path(d, 2).exists()
    assert ck.latest_checkpoint(d) == p1
    p2 = ck.save_step(d, 2, tree)        # the fault is consumed
    assert ck.latest_checkpoint(d) == p2


def test_latest_checkpoint_skips_a_damaged_newest_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(1, 5):
        ck.save_step(d, s, {"w": np.full(3, s, np.float32)}, keep=2)
    assert sorted(p.name for p in (tmp_path / "ck").glob("step_*")) == [
        "step_00000003.ckpt", "step_00000004.ckpt"]
    newest = ck.step_path(d, 4)
    newest.write_bytes(newest.read_bytes()[:-3])
    assert ck.latest_checkpoint(d) == str(ck.step_path(d, 3))
    assert ck.latest_checkpoint(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("background", [False, True])
def test_async_snapshot_is_isolated_from_in_place_updates(tmp_path,
                                                          background):
    """ppo_update writes params in place: the saved values are those at
    save(), not after, also for CPU tensors (whose .cpu() would alias)."""
    w = torch.arange(4, dtype=torch.float32)
    with ck.AsyncCheckpointer(str(tmp_path), background=background) as c:
        c.save(1, {"w": w, "m": [w * 2]})
        w.add_(100.0)                    # the next episode's update
    arrays, _ = ck.restore(ck.latest_checkpoint(str(tmp_path)))
    np.testing.assert_array_equal(arrays["w"], np.arange(4))
    np.testing.assert_array_equal(arrays["m/0"], 2 * np.arange(4))
    assert c.saves == 1 and c.bytes_written > 0 and c.time_blocked >= 0


def test_async_write_error_surfaces_on_next_call(tmp_path):
    c = ck.AsyncCheckpointer(str(tmp_path))
    faults.configure({"ckpt_crash": {"step": 1}})
    c.save(1, {"w": np.ones(2)})
    with pytest.raises(OSError, match="injected ckpt_crash"):
        c.wait()
    c.close()


# ---------------------------------------------------------------------------
# the two packages refuse each other's files
# ---------------------------------------------------------------------------

def test_reference_checkpoint_refused_by_the_port(tmp_path):
    from repro.ckpt import checkpoint as jck
    p = str(tmp_path / "ref.ckpt")
    jck.save(p, {"w": np.ones(3, np.float32)}, step=1)
    for load in (ck.restore, ck.validate, ck.read_manifest,
                 lambda q: ts_mod.load_train_state(q, "cpu")):
        with pytest.raises(ck.CheckpointError,
                           match="JAX package.*train_state_from_numpy"):
            load(p)
    assert ck.latest_checkpoint(str(tmp_path)) is None


def test_port_checkpoint_refused_by_the_reference(tmp_path):
    from repro.ckpt import checkpoint as jck
    d = str(tmp_path / "port")
    ck.save_step(d, 1, {"w": np.ones(3, np.float32)})
    with pytest.raises(jck.CheckpointError, match="not a repro checkpoint"):
        jck.validate(str(ck.step_path(d, 1)))
    assert jck.latest_checkpoint(d) is None
    assert not ck.MAGIC.startswith(jck.MAGIC)


# ---------------------------------------------------------------------------
# train(): bitwise resume, torch against torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,scenarios", [("mlp", None),
                                              ("attention", MIXED)])
def test_train_bitwise_resume(tmp_path, monkeypatch, policy, scenarios):
    dA, dB = str(tmp_path / "A"), str(tmp_path / "B")
    kw = dict(policy=policy, scenarios=scenarios)
    hist_a, model_a = train(_cfg(2, dA, **kw), log_fn=None)
    hist_k, _ = train(_cfg(1, dB, **kw), log_fn=None)

    def no_warmup(*a, **k):
        raise AssertionError("a resume must not warm up")

    monkeypatch.setattr(CylinderEnv, "_warmup_groups", no_warmup)
    logs = []
    hist_b, model_b = train(_cfg(2, dB, resume=True, **kw),
                            log_fn=logs.append)
    assert any("resume:" in line for line in logs), logs
    assert networks.is_attention(model_b) == (policy == "attention")
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k
    for f in ("reward", "cd", "cl", "quarantines", "grad_skips"):
        np.testing.assert_array_equal(hist_a[f], hist_b[f])
        np.testing.assert_array_equal(hist_k[f], hist_b[f][:1])
    ts_a, meta_a = ts_mod.load_train_state(ck.latest_checkpoint(dA), "cpu")
    ts_b, _ = ts_mod.load_train_state(ck.latest_checkpoint(dB), "cpu")
    assert ts_a.episode == ts_b.episode == 2
    assert ts_a.step == ts_b.step == 8
    _assert_states_equal(ts_a, ts_b)
    assert meta_a["framework"] == "torch"
    assert meta_a["policy"]["policy"] == policy


def test_resume_at_target_trains_nothing(tmp_path):
    d = str(tmp_path / "c")
    train(_cfg(1, d), log_fn=None)
    logs = []
    hist, model = train(_cfg(1, d, resume=True), log_fn=logs.append)
    assert len(hist["reward"]) == 1
    assert any("nothing to train" in line for line in logs), logs
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_resume_auto_is_fresh_when_empty(tmp_path):
    d = str(tmp_path / "fresh")
    # ckpt_every=0 must not divide by zero: treated as every episode
    hist, _ = train(dataclasses.replace(_cfg(1, d, resume="auto"),
                                        ckpt_every=0), log_fn=None)
    assert len(hist["reward"]) == 1
    assert ck.latest_checkpoint(d) is not None


def test_resume_needs_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="ckpt_dir"):
        ts_mod.resolve_resume(True, None)
    with pytest.raises(ck.CheckpointError, match="no valid checkpoint"):
        ts_mod.resolve_resume("latest", str(tmp_path))
    with pytest.raises(ck.CheckpointError, match="not found"):
        ts_mod.resolve_resume(str(tmp_path / "nope.ckpt"))


@pytest.fixture(scope="module")
def mixed_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mixed"))
    train(_cfg(1, d, scenarios=MIXED), log_fn=None)
    return d


@pytest.mark.parametrize("change,field", [
    (dict(n_envs=4), "n_envs"),
    (dict(policy="attention"), "policy"),
    (dict(scenarios=("pinball_re100", "cyl_re100")), "scenarios"),
    (dict(env=EnvConfig(grid=GridConfig(**{**GRID, "dt": 0.01}), **ENV_KW)),
     "grid"),
])
def test_strict_field_mismatch_raises(mixed_ckpt, change, field):
    cfg = dataclasses.replace(_cfg(2, mixed_ckpt, resume=True,
                                   scenarios=MIXED), **change)
    with pytest.raises(ck.CheckpointError, match=field):
        train(cfg, log_fn=None)


def test_seed_change_is_noted_not_refused(mixed_ckpt, tmp_path):
    logs = []
    cfg = dataclasses.replace(_cfg(1, mixed_ckpt, resume=True,
                                   scenarios=MIXED), seed=7)
    train(cfg, log_fn=logs.append)
    assert any("seed differs" in line for line in logs), logs


def _rewrite(src, dst, edit_meta=None, edit_state=None):
    ts, meta = ts_mod.load_train_state(src, "cpu")
    if edit_state is not None:
        ts = edit_state(ts)
    if edit_meta is not None:
        meta = edit_meta(dict(meta))
    ts_mod.save_train_state(dst, ts, metadata=meta)
    return dst


def test_framework_mismatch_raises(mixed_ckpt, tmp_path):
    """A state whose fingerprint says JAX never resumes as a torch one."""
    p = _rewrite(ck.latest_checkpoint(mixed_ckpt), str(tmp_path / "j.ckpt"),
                 edit_meta=lambda m: {**m, "framework": "jax"})
    with pytest.raises(ck.CheckpointError, match="framework"):
        train(_cfg(2, resume=p, scenarios=MIXED), log_fn=None)
    meta = ts_mod.run_metadata(n_envs=2, obs_dim=149, seed=0,
                               grid=GridConfig(), horizon=3,
                               steps_per_action=3, scenarios=None)
    ref_like = {k: v for k, v in meta.items() if k != "framework"}
    with pytest.raises(ck.CheckpointError, match="framework"):
        ts_mod.check_resume_compatible(ref_like, meta)


def test_geom_id_off_the_bank_raises(mixed_ckpt, tmp_path):
    """Each env's geom_id must index its own geometry's slot of the bank a
    resume builds, or the per-body kernel would read another body's
    planes."""
    def swap(ts):
        scn = ts.env_state.scn._replace(
            geom_id=ts.env_state.scn.geom_id.flip(0))
        return ts._replace(env_state=ts.env_state._replace(scn=scn))

    p = _rewrite(ck.latest_checkpoint(mixed_ckpt), str(tmp_path / "g.ckpt"),
                 edit_state=swap)
    with pytest.raises(ck.CheckpointError, match="geom_id"):
        train(_cfg(2, resume=p, scenarios=MIXED), log_fn=None)


# ---------------------------------------------------------------------------
# a reference run carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A 1-episode reference run of the attention policy on the mixed batch
    and its checkpoint's tree, read on the JAX side."""
    from repro.cfd.env import EnvConfig as JEnvConfig
    from repro.cfd.grid import GridConfig as JGridConfig
    from repro.ckpt import checkpoint as jck
    from repro.drl import train as jtrain
    from repro.drl import train_state as jts
    from repro.drl.ppo import PPOConfig as JPPOConfig
    d = str(tmp_path_factory.mktemp("ref"))
    hist, _ = jtrain.train(jtrain.TrainConfig(
        env=JEnvConfig(grid=JGridConfig(**GRID), **ENV_KW),
        ppo=JPPOConfig(epochs=2, minibatches=2), n_envs=2, episodes=1,
        seed=0, ckpt_dir=d, ckpt_every=1, policy="attention",
        scenarios=MIXED), log_fn=None)
    arrays, _ = jck.restore(jck.latest_checkpoint(d))
    return jts._nest(arrays), hist


def test_reference_state_carried_leaf_by_leaf(reference_ckpt):
    tree, _ = reference_ckpt
    ts = train_state_from_numpy(tree, "cpu", seed=0)
    model = networks.init_actor_critic(
        networks.PolicyConfig(obs_dim=149, act_dim=3, policy="attention"),
        torch.Generator(), device="cpu")
    model.load_state_dict(ts.params)
    got = {"params": params_to_numpy(model)}
    for k in ("m", "v"):
        with torch.no_grad():
            for p, a in zip(model.parameters(), ts.opt_state[k]):
                p.copy_(a)
        got[k] = params_to_numpy(model)
    for name, want in (("params", tree["params"]),
                       ("m", tree["opt_state"]["m"]),
                       ("v", tree["opt_state"]["v"])):
        fw = ck._flatten_with_paths(want)
        fg = ck._flatten_with_paths(got[name])
        assert sorted(fw) == sorted(fg), name
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k], err_msg=f"{name}/{k}")
    assert ts.step == int(tree["step"]) == 4
    assert ts.episode == int(tree["episode"]) == 1
    st, ref = ts.env_state, tree["env_state"]
    for part in ("flow", "reset_flow"):
        for k in ("u", "v", "p"):
            np.testing.assert_array_equal(
                getattr(getattr(st, part), k).numpy(), ref[part][k])
    for k, v in ref["scn"].items():
        np.testing.assert_array_equal(getattr(st.scn, k).numpy(), v)
    assert st.scn.geom_id.dtype == st.t.dtype == torch.int64
    np.testing.assert_array_equal(st.jet_vel.numpy(), ref["jet_vel"])
    np.testing.assert_array_equal(st.t.numpy(), ref["t"])
    np.testing.assert_array_equal(ts.obs.numpy(), tree["obs"])
    for k in ts_mod.HISTORY_FIELDS:
        np.testing.assert_array_equal(ts.history[k], tree["history"][k])
    assert torch.equal(ts.rng, torch.Generator().manual_seed(0).get_state())


def test_reference_state_resumes_in_the_port(reference_ckpt, tmp_path):
    """Written with the port's fingerprint, the carried state resumes: no
    warmup, the reference's episode kept in the history, one more run."""
    tree, ref_hist = reference_ckpt
    cfg = _cfg(2, policy="attention", scenarios=MIXED)
    p = str(tmp_path / "carried.ckpt")
    ts_mod.save_train_state(p, train_state_from_numpy(tree, "cpu"),
                            metadata=ts_mod.run_metadata(
                                n_envs=2, obs_dim=149, seed=0,
                                grid=cfg.env.grid, horizon=3,
                                steps_per_action=3, scenarios=MIXED,
                                policy={"policy": "attention",
                                        "obs_dim": 149, "act_dim": 3}))
    hist, model = train(dataclasses.replace(cfg, resume=p), log_fn=None)
    assert len(hist["reward"]) == 2
    np.testing.assert_array_equal(hist["reward"][:1], ref_hist["reward"])
    assert np.isfinite(hist["reward"]).all()
    assert all(torch.isfinite(q).all() for q in model.parameters())
