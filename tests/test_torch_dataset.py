"""The port's sharded trajectory dataset and offline replay.

Layers, cheapest first:
  * the format, on a toy 3-state env in torch (the reference tests'
    ``_toy_step``): the cases of tests/test_trajectory_dataset.py (round
    trip, shard rotation, crash-tail reopen, schema, truncation, crc flip,
    shard-table mismatch, missing shard, missing episode, zstd refusal);
  * across packages: a dataset recorded by the reference's
    ``train(sink=SinkSpec(kind="dataset"))`` reads in the port's
    ``TrajectoryReader`` and one recorded by the port's ``train()`` in the
    reference's, arrays equal; a reference zstd dataset is refused;
  * torch record -> replay, bit for bit: the port's ``train()`` with a
    dataset sink, then ``replay_sync`` from the seed leaves the same
    params, Adam moments, PPO step, generator state and returns;
  * against the reference: the reference's dataset replayed by the port
    (the reference's params converted, its permutations injected) and by
    the reference agree within ATOL_REPLAY.

The cylinder runs are at res 6, 2 envs, 3 actions (tools/replay_smoke.py's
sizes)."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.cfd.env import EnvConfig as JEnvConfig
from repro.cfd.grid import GridConfig as JGridConfig
from repro.data import trajectory_dataset as jds
from repro.drl import engine as jengine
from repro.drl import networks as jnet
from repro.drl import ppo as jppo
from repro.drl import train as jtrain
from repro.drl.rollout import Trajectory as JTrajectory
from repro_torch.cfd.env import EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.ckpt import checkpoint as ck
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.data.trajectory_dataset import (DATASET_SCHEMA, DatasetError,
                                                 DatasetSink,
                                                 TrajectoryReader)
from repro_torch.drl import networks
from repro_torch.drl import train_state as ts_mod
from repro_torch.drl.engine import (EngineConfig, MemorySink, RolloutEngine,
                                    SinkReadError, SinkSpec)
from repro_torch.drl.ppo import PPOConfig, make_optimizer
from repro_torch.drl.rollout import Trajectory
from repro_torch.drl.train import TrainConfig, train
from repro_torch.testing import faults
from tests._torch_parity import max_diff

N, T = 4, 8
PCFG = networks.PolicyConfig(obs_dim=3, act_dim=1, hidden=32)
PPO = PPOConfig(lr=1e-3, epochs=2, minibatches=2)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


class _Out:
    def __init__(self, obs, reward):
        self.obs, self.reward = obs, reward
        self.cd = torch.zeros_like(reward)
        self.cl = torch.zeros_like(reward)
        self.valid = None


def _toy_step(st, a):
    new = st * 0.8 + torch.tensor([0.5, 0.0, 0.0]) * a[:, None]
    return new, _Out(new, -torch.sum(new[:, :1] ** 2, dim=-1))


def _st0():
    return torch.ones(N, 3) * 2.0


def _engine(sink=None):
    return RolloutEngine(_toy_step, EngineConfig(n_envs=N, horizon=T),
                         sink=sink)


def _record(root, episodes=3, **sink_kw):
    """Collect ``episodes`` through a DatasetSink; returns the sink and the
    trajectories."""
    engine = _engine()
    model, _, _, _ = engine.init(PCFG, PPO, 0, device="cpu")
    sink = DatasetSink(str(root), **sink_kw)
    trajs = []
    for ep in range(episodes):
        _, traj = engine.collect(model, _st0(), _st0(),
                                 generator=torch.Generator().manual_seed(ep))
        sink.write(ep, traj)
        trajs.append(traj)
    return sink, trajs


def _equal(traj, back):
    for f, a, b in zip(Trajectory._fields, traj, back):
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# round trip, rotation, resume
# ---------------------------------------------------------------------------

def test_dataset_roundtrip(tmp_path):
    sink, trajs = _record(tmp_path / "ds", episodes=3)
    sink.annotate(run="unit", seed=7, path=tmp_path)
    reader = TrajectoryReader(tmp_path / "ds")
    assert reader.episodes == [0, 1, 2] and len(reader) == 3
    assert reader.metadata == {"run": "unit", "seed": 7,
                               "path": str(tmp_path)}
    for ep, traj in enumerate(trajs):
        back = reader.read(ep)
        assert isinstance(back, Trajectory)
        _equal(traj, back)                # float32 in, float32 out: exact
    assert [t.obs.shape for t in reader] == [(N, T, 3)] * 3
    man = json.loads((tmp_path / "ds" / "manifest.json").read_text())
    assert man["schema"] == DATASET_SCHEMA and man["codec"] == "binary"
    assert man["episodes"]["1"]["shape"]["obs"] == [N, T, 3]


def test_shard_rotation_and_read_across_shards(tmp_path):
    root = tmp_path / "ds"
    _, trajs = _record(root, episodes=4, shard_max_bytes=1)
    # a 1-byte budget: every record rotates into its own shard
    assert sorted(p.name for p in root.glob("shard_*.bin")) == [
        f"shard_{i:05d}.bin" for i in range(4)]
    reader = TrajectoryReader(root)
    for ep, traj in enumerate(trajs):
        _equal(traj, reader.read(ep))


def test_reopen_resumes_and_overwrites_crash_tail(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=2)
    shard = root / "shard_00000.bin"
    committed = shard.stat().st_size
    # a crash mid-append: un-indexed tail bytes past the committed count
    # are invisible to readers and overwritten by the next append
    with open(shard, "ab") as f:
        f.write(b"\xde\xad\xbe\xef" * 8)
    assert TrajectoryReader(root).episodes == [0, 1]
    sink2 = DatasetSink(str(root))                  # reopen = resume
    traj2 = _record(tmp_path / "other", episodes=1)[1][0]
    sink2.write(2, traj2)
    reader = TrajectoryReader(root)
    assert reader.episodes == [0, 1, 2]
    _equal(traj2, reader.read(2))
    man = json.loads((root / "manifest.json").read_text())
    assert man["episodes"]["2"]["offset"] == committed
    assert shard.stat().st_size == man["shards"]["shard_00000.bin"]


# ---------------------------------------------------------------------------
# corruption: every failure mode is a loud, named error
# ---------------------------------------------------------------------------

def test_missing_manifest_and_wrong_schema(tmp_path):
    with pytest.raises(DatasetError, match="missing manifest.json"):
        TrajectoryReader(tmp_path / "nowhere")
    root = tmp_path / "notds"
    root.mkdir()
    (root / "manifest.json").write_text(json.dumps({"schema": "other/v9"}))
    with pytest.raises(DatasetError, match="not a trajectory dataset"):
        TrajectoryReader(root)
    with pytest.raises(DatasetError, match="not a trajectory dataset"):
        DatasetSink(str(root))


@pytest.mark.parametrize("cut", [1, 8, 100])
def test_truncated_shard_detected(tmp_path, cut):
    root = tmp_path / "ds"
    _record(root, episodes=2)
    shard = root / "shard_00000.bin"
    with open(shard, "r+b") as f:
        f.truncate(max(0, shard.stat().st_size - cut))
    with pytest.raises(DatasetError, match="truncated shard"):
        TrajectoryReader(root)
    # validate=False defers to read time, which still refuses short bytes
    reader = TrajectoryReader(root, validate=False)
    with pytest.raises(DatasetError):
        for ep in reader.episodes:
            reader.read(ep)


def test_crc_bit_flip_detected(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=1)
    shard = root / "shard_00000.bin"
    with open(shard, "r+b") as f:
        f.seek(shard.stat().st_size // 2)       # well inside the payload
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x01]))
    reader = TrajectoryReader(root)             # sizes intact: validate OK
    with pytest.raises(DatasetError, match="crc32 mismatch"):
        reader.read(0)


def test_record_header_mismatch_detected(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=1)
    shard = root / "shard_00000.bin"
    with open(shard, "r+b") as f:
        f.write((1).to_bytes(8, "little"))      # the length frame lies
    with pytest.raises(DatasetError, match="corrupted shard"):
        TrajectoryReader(root).read(0)


def test_manifest_shard_table_mismatch(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=1)
    mpath = root / "manifest.json"
    man = json.loads(mpath.read_text())
    man["episodes"]["0"]["shard"] = "shard_00042.bin"
    mpath.write_text(json.dumps(man))
    with pytest.raises(DatasetError, match="manifest/shard-count mismatch"):
        TrajectoryReader(root)


def test_missing_shard_file_detected(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=1)
    (root / "shard_00000.bin").unlink()
    with pytest.raises(DatasetError, match="missing shard"):
        TrajectoryReader(root)
    with pytest.raises(DatasetError, match="missing shard"):
        TrajectoryReader(root, validate=False).read(0)


def test_missing_episode_is_actionable_keyerror(tmp_path):
    root = tmp_path / "ds"
    _record(root, episodes=2)
    reader = TrajectoryReader(root)
    with pytest.raises(KeyError):               # SinkReadError is a KeyError
        reader.read(99)
    with pytest.raises(SinkReadError) as ei:
        reader.read(99)
    msg = str(ei.value)
    assert str(root) in msg and "episodes 0..1" in msg and "codec" in msg


def test_zstd_refused_and_fresh_zstd_written_binary(tmp_path):
    """A fresh dataset asked for zstd is written binary; a reference
    dataset whose manifest says zstd (written here by the reference with
    zstandard, when installed; by its manifest alone otherwise) raises
    DatasetError naming the codec, to read and to append."""
    assert DatasetSink(str(tmp_path / "fresh"), codec="zstd").codec == "binary"
    assert TrajectoryReader(tmp_path / "fresh").codec == "binary"
    root = tmp_path / "zstd"
    jsink = jds.DatasetSink(str(root), codec="zstd")
    z = np.zeros((2, 3), np.float32)
    jsink.write(0, JTrajectory(obs=np.zeros((2, 3, 3), np.float32),
                               act=np.zeros((2, 3, 1), np.float32), logp=z,
                               reward=z, cd=z, cl=z,
                               last_obs=np.zeros((2, 3), np.float32)))
    if jsink.codec != "zstd":                   # zstandard absent
        man = json.loads((root / "manifest.json").read_text())
        man["codec"] = "zstd"
        (root / "manifest.json").write_text(json.dumps(man))
    with pytest.raises(DatasetError, match="codec 'zstd'.*cannot read"):
        TrajectoryReader(root)
    with pytest.raises(DatasetError, match="codec 'zstd'.*cannot append"):
        DatasetSink(str(root))


def test_unknown_codec_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown trajectory-sink codec"):
        DatasetSink(str(tmp_path / "ds"), codec="gzip")


# ---------------------------------------------------------------------------
# offline replay on the toy engine
# ---------------------------------------------------------------------------

def _assert_same_run(model_a, opt_a, gen_a, model_b, opt_b, gen_b):
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k
    for k in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(opt_a[k], opt_b[k])), k
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.parametrize("where", ["dataset", "memory", "file"])
def test_replay_reproduces_live_run_bitwise(tmp_path, where):
    """run_sync with a sink, then replay_sync from the same seed: the same
    params, moments, generator state, step and returns, whatever the
    sink (any reader with read(ep) -> Trajectory)."""
    episodes = 3
    sink = {"dataset": lambda: DatasetSink(str(tmp_path / "ds")),
            "memory": lambda: MemorySink(keep=episodes),
            "file": lambda: SinkSpec(kind="binary",
                                     root=str(tmp_path / "f")).build()
            }[where]()
    live = _engine(sink)
    model, optimizer, opt_state, gen = live.init(PCFG, PPO, 3, device="cpu")
    steps = []
    model, opt_live, ret_live = live.run_sync(
        model, opt_state, PPO, optimizer, _st0(), _st0(), episodes,
        generator=gen, on_state=lambda c: steps.append(c.step))

    reader = TrajectoryReader(tmp_path / "ds") if where == "dataset" else sink
    replayer = RolloutEngine(None, EngineConfig(n_envs=N, horizon=T))
    model_r, optimizer, opt_state, gen_r = replayer.init(PCFG, PPO, 3,
                                                         device="cpu")
    steps_r = []
    model_r, opt_r, ret_r = replayer.replay_sync(
        reader, model_r, opt_state, PPO, optimizer, episodes,
        generator=gen_r, on_state=lambda c: steps_r.append(c.step))
    _assert_same_run(model, opt_live, gen, model_r, opt_r, gen_r)
    np.testing.assert_array_equal(ret_live, ret_r)
    assert steps == steps_r == [4, 8, 12]


def test_replay_start_offset_and_burn_discipline(tmp_path):
    """start= replays a suffix from the carry after episode 1; and a replay
    that burned one draw of N*T values in place of T draws of (N, 1)
    would not be the live run (the burn must mirror sample_action)."""
    live = _engine(DatasetSink(str(tmp_path / "ds")))
    model, optimizer, opt_state, gen = live.init(PCFG, PPO, 5, device="cpu")
    carries = []

    def on_state(c):
        # the update writes params in place: keep copies
        sd = c.model.state_dict()
        carries.append(({k: v.clone() for k, v in sd.items()},
                        {k: [x.clone() for x in v]
                         for k, v in c.opt_state.items()},
                        c.step, c.generator.get_state()))

    model, opt_live, _ = live.run_sync(
        model, opt_state, PPO, optimizer, _st0(), _st0(), 3, generator=gen,
        on_state=on_state)
    params1, opt1, step1, rng1 = carries[0]
    model_r = networks.init_actor_critic(PCFG, torch.Generator(), "cpu")
    model_r.load_state_dict(params1)
    gen_r = torch.Generator()
    gen_r.set_state(rng1)
    reader = TrajectoryReader(tmp_path / "ds")
    model_r, opt_r, _ = live.replay_sync(
        reader, model_r, opt1, PPO, optimizer, 2, generator=gen_r,
        step=step1, start=1)
    _assert_same_run(model, opt_live, gen, model_r, opt_r, gen_r)

    gen_a = torch.Generator().manual_seed(9)
    networks.burn_action_noise(N, 1, T, gen_a)
    gen_b = torch.Generator().manual_seed(9)
    for _ in range(T):
        torch.randn((N, 1), generator=gen_b)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


# ---------------------------------------------------------------------------
# the cylinder at res 6: the port's train() recorded and replayed, and the
# reference's dataset in both packages
# ---------------------------------------------------------------------------

GRID = dict(res=6, dt=0.012, poisson_iters=30)
ENV_KW = dict(steps_per_action=3, actions_per_episode=3, warmup_time=1.0)
EPISODES = 3

# Both replays of the reference's dataset feed the same recorded
# observations through their own float32 MLPs (values ~1e-6 apart, as
# tests/test_torch_drl.py holds them), then 2 epochs x 2 minibatches of
# Adam per episode: tests/test_torch_train.py holds the same updates on
# the same batches to 1e-5, and this replay to the same (it reads 8.2e-7
# on this CPU over the 3 episodes).
ATOL_REPLAY = 1e-5


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    base = tmp_path_factory.mktemp("port")
    cfg = TrainConfig(env=EnvConfig(grid=GridConfig(**GRID), **ENV_KW),
                      ppo=PPOConfig(epochs=2, minibatches=2), n_envs=2,
                      episodes=EPISODES, seed=0, device="cpu",
                      sink=SinkSpec(kind="dataset", root=str(base / "ds")),
                      ckpt_dir=str(base / "ck"), ckpt_every=EPISODES)
    hist, model = train(cfg, log_fn=None)
    ts, _ = ts_mod.load_train_state(ck.latest_checkpoint(str(base / "ck")),
                                    "cpu")
    return dict(cfg=cfg, hist=hist, model=model, ts=ts, root=base / "ds")


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref") / "ds"
    cfg = jtrain.TrainConfig(
        env=JEnvConfig(grid=JGridConfig(**GRID), **ENV_KW),
        ppo=jppo.PPOConfig(epochs=2, minibatches=2), n_envs=2,
        episodes=EPISODES, seed=0,
        sink=jengine.SinkSpec(kind="dataset", root=str(root)))
    hist, params = jtrain.train(cfg, log_fn=None)
    return dict(cfg=cfg, hist=hist, params=params, root=root)


def test_port_record_replay_is_bitwise(port_run):
    """The port's train() with a dataset sink, then replay_sync from the
    seed in the manifest: params, Adam moments, PPO step, generator state
    and per-episode returns equal to the live run's."""
    reader = TrajectoryReader(port_run["root"])
    meta = reader.metadata
    assert reader.episodes == list(range(EPISODES))
    assert meta["framework"] == "torch" and meta["seed"] == 0
    cfg = port_run["cfg"]
    engine = RolloutEngine(None, EngineConfig(
        n_envs=meta["n_envs"], horizon=meta["horizon"], gamma=cfg.ppo.gamma,
        lam=cfg.ppo.lam))
    pcfg = networks.PolicyConfig(obs_dim=meta["obs_dim"],
                                 act_dim=meta["policy"]["act_dim"])
    model, optimizer, opt_state, gen = engine.init(pcfg, cfg.ppo,
                                                   meta["seed"], "cpu")
    steps = []
    model, opt_state, returns = engine.replay_sync(
        reader, model, opt_state, cfg.ppo, optimizer, len(reader),
        generator=gen, on_state=lambda c: steps.append(c.step))
    ts = port_run["ts"]
    for (k, a), b in zip(model.state_dict().items(),
                         port_run["model"].state_dict().values()):
        assert torch.equal(a, b), k
    for k in ("m", "v"):
        assert all(torch.equal(a, b)
                   for a, b in zip(opt_state[k], ts.opt_state[k])), k
    assert steps[-1] == ts.step
    assert torch.equal(gen.get_state(), ts.rng)
    np.testing.assert_array_equal(returns, port_run["hist"]["reward"])


def test_reference_dataset_reads_in_the_port(ref_run):
    ours = TrajectoryReader(ref_run["root"])
    ref = jds.TrajectoryReader(str(ref_run["root"]))
    assert ours.episodes == ref.episodes == list(range(EPISODES))
    assert ours.metadata == ref.metadata
    for ep in ours.episodes:
        a, b = ref.read(ep), ours.read(ep)
        assert a._fields == b._fields
        for f, x, y in zip(a._fields, a, b):
            if x is None:
                assert y is None, f
                continue
            assert y.dtype == np.float32 and y.shape == x.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_port_dataset_reads_in_the_reference(port_run):
    ours = TrajectoryReader(port_run["root"])
    ref = jds.TrajectoryReader(str(port_run["root"]))
    assert ref.episodes == ours.episodes and ref.metadata == ours.metadata
    for ep in ours.episodes:
        a, b = ours.read(ep), ref.read(ep)
        for f, x, y in zip(a._fields, a, b):
            if x is None:
                assert y is None, f
                continue
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)


def _reference_perms(key, n_samples, epochs):
    """run_sync's / replay_sync's per-episode update keys, as the epoch
    permutations ppo_update draws from them."""
    out = []
    for _ in range(EPISODES):
        key, _, ku = jax.random.split(key, 3)
        out.append(np.stack([np.asarray(jax.random.permutation(k, n_samples))
                             for k in jax.random.split(ku, epochs)]))
    return out


def test_port_replay_of_the_reference_dataset_matches_its_replay(ref_run):
    """The reference's dataset, replayed by the reference from its seed and
    by the port from the reference's initial params (convert.py) with the
    reference's permutations injected: params within ATOL_REPLAY after
    every episode's update, and the returns equal (the rewards are read,
    not computed)."""
    cfg = ref_run["cfg"]
    jreader = jds.TrajectoryReader(str(ref_run["root"]))
    meta = jreader.metadata
    jeng = jengine.RolloutEngine(
        lambda st, a: None,
        jengine.EngineConfig(n_envs=meta["n_envs"], horizon=meta["horizon"],
                             gamma=cfg.ppo.gamma, lam=cfg.ppo.lam))
    jpcfg = jnet.PolicyConfig(obs_dim=meta["obs_dim"])
    params0, joptim, jopt0, key = jeng.init(jpcfg, cfg.ppo, meta["seed"])
    jparams = []
    _, _, jret = jeng.replay_sync(
        jreader, params0, jopt0, cfg.ppo, joptim, key, EPISODES,
        on_state=lambda c: jparams.append(jax.tree.map(np.asarray,
                                                       c.params)))
    # the reference's replay is its live run, bit for bit
    np.testing.assert_array_equal(jret, ref_run["hist"]["reward"])

    ppo = PPOConfig(epochs=2, minibatches=2)
    model = params_from_jax(jax.tree.map(np.asarray, params0), device="cpu")
    optimizer = make_optimizer(ppo)
    opt_state = optimizer.init(list(model.parameters()))
    engine = RolloutEngine(None, EngineConfig(
        n_envs=meta["n_envs"], horizon=meta["horizon"], gamma=ppo.gamma,
        lam=ppo.lam))
    ours = []
    perms = _reference_perms(key, meta["n_envs"] * meta["horizon"],
                             ppo.epochs)
    _, _, ret = engine.replay_sync(
        TrajectoryReader(ref_run["root"]), model, opt_state, ppo, optimizer,
        EPISODES, perms=perms,
        on_state=lambda c: ours.append(params_to_numpy(c.model)))
    np.testing.assert_array_equal(ret, jret)
    moved = 0.0
    for ref, out in zip(jparams, ours):
        for side in ("actor", "critic"):
            for a, o in zip(ref[side], out[side]):
                for k in ("w", "b"):
                    assert max_diff(a[k], o[k])[0] <= ATOL_REPLAY, (side, k)
        assert max_diff(ref["log_std"], out["log_std"])[0] <= ATOL_REPLAY
        moved = max(moved, max_diff(params0["critic"][0]["w"],
                                    out["critic"][0]["w"])[0])
    assert moved > 1e-3                      # the updates did move params
