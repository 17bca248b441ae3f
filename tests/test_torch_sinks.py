"""The port's trajectory sinks and their wiring into the sync engine and
``train()``: the cases of the reference's tests/test_engine.py (sinks,
``SinkSpec``, ``make_sink``, timing) and tests/test_selfheal.py (sink
retries) that apply to the sync engine, on the port's own fault injector.

The engine cases run a toy 3-state env in torch (the reference tests'
``_toy_step``); the ``train()`` cases the cylinder at res 6.  Every
comparison is exact: sinks store float32, which the trajectories are."""
import warnings

import numpy as np
import pytest
import torch

from repro_torch.cfd.env import EnvConfig
from repro_torch.cfd.grid import GridConfig
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core.interface import MultiEnvInterface
from repro_torch.data.trajectory_dataset import DatasetSink, TrajectoryReader
from repro_torch.drl import networks
from repro_torch.drl.engine import (EngineConfig, FileSink, MemorySink,
                                    RolloutEngine, SinkReadError, SinkSpec,
                                    TrajectorySink, make_sink)
from repro_torch.drl.ppo import PPOConfig
from repro_torch.drl.rollout import Trajectory
from repro_torch.drl.train import TrainConfig, train
from repro_torch.testing import faults
from tests import _torch_parity  # noqa: F401  (one thread, TF32 off)

N, T = 4, 6
PCFG = networks.PolicyConfig(obs_dim=3, act_dim=1, hidden=32)
PPO = PPOConfig(lr=1e-3, epochs=2, minibatches=2)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()      # a test that armed faults must not leak them


class _Out:
    def __init__(self, obs, reward):
        self.obs, self.reward = obs, reward
        self.cd = torch.zeros_like(reward)
        self.cl = torch.zeros_like(reward)
        self.valid = None


def _toy_step(st, a):
    new = st * 0.8 + torch.tensor([0.5, 0.0, 0.0]) * a[:, None]
    return new, _Out(new, -torch.sum(new[:, :1] ** 2, dim=-1))


def _engine(**kw):
    return RolloutEngine(_toy_step, EngineConfig(n_envs=N, horizon=T, **kw))


def _init(engine, seed=0):
    return engine.init(PCFG, PPO, seed, device="cpu")


def _st0():
    return torch.ones(N, 3) * 2.0


def _collect_one(seed=7):
    engine = _engine()
    model, _, _, _ = _init(engine)
    _, traj = engine.collect(model, _st0(), _st0(),
                             generator=torch.Generator().manual_seed(seed))
    return traj


def _assert_traj_equal(traj, back):
    for f, a, b in zip(Trajectory._fields, traj, back):
        if a is None or b is None:      # absent aux fields: absent both ways
            assert a is None and b is None, f
            continue
        assert isinstance(b, np.ndarray) and b.dtype == np.float32, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["binary", "zstd"])
def test_file_sink_roundtrip(tmp_path, codec):
    """'zstd' writes the binary payload (no zstd codec in the port)."""
    sink = FileSink(str(tmp_path / codec), codec=codec)
    assert sink.codec == "binary"
    traj = _collect_one()
    nb = sink.write(0, traj)
    assert nb > 0 and sink.bytes_written == nb and sink.episodes == 1
    assert sink.time_spent > 0.0
    assert (tmp_path / codec / "traj_000000.bin").stat().st_size == nb
    _assert_traj_equal(traj, sink.read(0))
    with pytest.raises(KeyError):
        sink.read(99)
    sink.close()                      # close never destroys spilled data
    _assert_traj_equal(traj, sink.read(0))
    sink.cleanup()
    assert not sink.dir.exists()
    sink.cleanup()                    # a second cleanup: no error
    with pytest.raises(SinkReadError):
        sink.read(0)                  # the spilled data is gone


@pytest.mark.parametrize("keep,order,gone,kept", [
    (2, (0, 1, 2, 3), (0, 1), (2, 3)),
    (2, (5, 3, 7), (3,), (5, 7)),     # out-of-order: the lowest id goes
    (1, (0, 1), (0,), (1,)),
])
def test_memory_sink_eviction(keep, order, gone, kept):
    sink = MemorySink(keep=keep)
    traj = _collect_one()
    for ep in order:
        sink.write(ep, traj)
    assert sink.episodes == len(order)
    for ep in gone:
        with pytest.raises(KeyError):
            sink.read(ep)
    for ep in kept:
        _assert_traj_equal(traj, sink.read(ep))


def test_base_sink_is_a_noop():
    sink = TrajectorySink()
    assert sink.write(0, _collect_one()) == 0 and sink.episodes == 1
    with pytest.raises(SinkReadError, match="does not retain"):
        sink.read(0)


def test_engine_records_to_sink():
    sink = MemorySink()
    engine = RolloutEngine(_toy_step, EngineConfig(n_envs=N, horizon=T),
                           sink=sink)
    model, _, _, g = _init(engine)
    _, t0 = engine.collect(model, _st0(), _st0(), generator=g)
    _, t1 = engine.collect(model, _st0(), _st0(), generator=g)
    _, t2 = engine.collect(model, _st0(), _st0(), generator=g, record=False)
    assert sink.episodes == 2 and engine.episode == 3
    assert sink.read(1).obs.shape == (N, T, 3)
    _assert_traj_equal(t1, sink.read(1))
    with pytest.raises(SinkReadError):
        sink.read(2)


def test_make_sink_modes_and_rejections(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert make_sink("none") is None
        assert isinstance(make_sink("memory"), MemorySink)
        fs = make_sink("binary", str(tmp_path))
        assert isinstance(fs, FileSink)
        fs.cleanup()
        with pytest.raises(ValueError, match="unknown sink mode"):
            make_sink("parquet", str(tmp_path))
        with pytest.raises(ValueError, match="root directory"):
            make_sink("binary")                   # a file sink needs a root


def test_make_sink_deprecation_blames_caller():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sink = make_sink("memory")
    assert isinstance(sink, MemorySink)
    assert len(w) == 1 and issubclass(w[0].category, DeprecationWarning)
    assert "SinkSpec" in str(w[0].message)
    assert w[0].filename == __file__


def test_file_sink_unknown_codec():
    with pytest.raises(ValueError, match="unknown trajectory-sink codec"):
        FileSink("/nonexistent/never_created", codec="gzip")


def test_file_sink_read_before_write(tmp_path):
    sink = FileSink(str(tmp_path / "empty"))
    with pytest.raises(KeyError, match="episode 0"):
        sink.read(0)
    assert sink.episodes == 0 and sink.bytes_written == 0


# ---------------------------------------------------------------------------
# SinkSpec
# ---------------------------------------------------------------------------

def test_sink_spec_parse_and_build(tmp_path):
    assert SinkSpec.parse(None).build() is None
    assert SinkSpec.parse("none").build() is None
    assert SinkSpec.parse("disabled").kind == "none"
    assert isinstance(SinkSpec.parse("memory").build(), MemorySink)
    fs = SinkSpec.parse(f"binary:{tmp_path}/b").build()
    assert isinstance(fs, FileSink) and fs.codec == "binary"
    assert SinkSpec.parse(f"zstd:{tmp_path}/z").build().codec == "binary"
    ds = SinkSpec.parse(f"dataset:{tmp_path}/d").build()
    assert isinstance(ds, DatasetSink) and ds.root == tmp_path / "d"
    assert SinkSpec(kind="memory", keep=3).build().keep == 3
    ds = SinkSpec(kind="dataset", root=str(tmp_path / "s"),
                  shard_max_bytes=1).build()
    assert ds.shard_max_bytes == 1


@pytest.mark.parametrize("spec,match", [
    (dict(kind="parquet", root="x"), "unknown sink kind"),
    (dict(kind="binary"), "needs a root directory"),
    (dict(kind="zstd"), "needs a root directory"),
    (dict(kind="dataset"), "needs a root directory"),
    (dict(kind="dataset", root="DIR", codec="gzip"),
     "unknown trajectory-sink codec"),
])
def test_sink_spec_rejects_bad_specs(tmp_path, spec, match):
    if spec.get("root") == "DIR":
        spec = dict(spec, root=str(tmp_path / "d"))
    with pytest.raises(ValueError, match=match):
        SinkSpec(**spec).build()


def test_sink_spec_process_layout(tmp_path):
    """An explicit process suffixes file-sink episodes and puts the dataset
    in a part directory; the default is the flat layout in a
    single-process run, also under an initialised one-process group."""
    fs = SinkSpec(kind="binary", root=str(tmp_path / "f"), process=2).build()
    fs.write(7, _collect_one())
    assert [p.name for p in fs.dir.iterdir()] == ["traj_000007.p002.bin"]
    with pytest.raises(SinkReadError, match=r"episodes 7\.\.7"):
        fs.read(8)
    ds = SinkSpec(kind="dataset", root=str(tmp_path / "d"), process=1).build()
    assert ds.root == tmp_path / "d" / "part001"
    assert ds.metadata == {"process": 1}
    assert SinkSpec(kind="binary", root=str(tmp_path))._process() is None
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert SinkSpec(kind="binary", root=str(tmp_path))._process() is None
    finally:
        dist.destroy_process_group()


def test_engine_builds_sink_from_config_spec():
    engine = _engine(sink=SinkSpec(kind="memory", keep=2))
    assert isinstance(engine.sink, MemorySink) and engine.sink.keep == 2
    # an explicit sink= always wins over the config spec
    mine = MemorySink()
    engine = RolloutEngine(
        _toy_step, EngineConfig(n_envs=N, horizon=T,
                                sink=SinkSpec(kind="memory")), sink=mine)
    assert engine.sink is mine


def test_sink_read_errors_are_actionable(tmp_path):
    mem = MemorySink(keep=2)
    traj = _collect_one()
    for ep in range(3):
        mem.write(ep, traj)
    with pytest.raises(SinkReadError, match=r"keep=2\) retains episodes 1"):
        mem.read(0)                       # names the retention window
    fs = FileSink(str(tmp_path), codec="binary")
    fs.write(4, traj)
    with pytest.raises(SinkReadError) as ei:
        fs.read(99)
    msg = str(ei.value)
    assert str(tmp_path) in msg and "codec" in msg and "episode 99" in msg
    assert "episodes 4..4 (1 on disk)" in msg


def test_engine_timing_stats():
    engine = _engine(timing=True)
    model, optimizer, opt_state, g = _init(engine)
    engine.run_sync(model, opt_state, PPO, optimizer, _st0(), _st0(), 2,
                    generator=g)
    assert engine.stats["episodes"] == 2
    assert engine.stats["collect_s"] > 0 and engine.stats["update_s"] > 0
    untimed = _engine()
    model, optimizer, opt_state, g = _init(untimed)
    untimed.run_sync(model, opt_state, PPO, optimizer, _st0(), _st0(), 1,
                     generator=g)
    assert untimed.stats == {"collect_s": 0.0, "update_s": 0.0,
                             "episodes": 0}


def test_run_sync_on_batch_sees_every_batch_before_its_update():
    engine = _engine()
    model, optimizer, opt_state, g = _init(engine)
    seen = []

    def on_batch(batch):
        seen.append(batch.obs.shape)
        return batch._replace(adv=torch.zeros_like(batch.adv))

    engine.run_sync(model, opt_state, PPO, optimizer, _st0(), _st0(), 2,
                    generator=g, on_batch=on_batch)
    assert seen == [(N * T, 3)] * 2


# ---------------------------------------------------------------------------
# durability: sink retries through the fault injector
# ---------------------------------------------------------------------------

def _toy_traj():
    z = torch.zeros(2, 3)
    return Trajectory(obs=torch.zeros(2, 3, 3), act=torch.zeros(2, 3, 1),
                      logp=z, reward=z, cd=z, cl=z,
                      last_obs=torch.zeros(2, 3))


@pytest.mark.parametrize("kind", ["binary", "dataset"])
def test_sink_retry_recovers_and_counts(tmp_path, kind):
    sink = SinkSpec(kind=kind, root=str(tmp_path / "spill")).build()
    faults.configure({"sink_oserror": {"times": 2}})
    sink.write(0, _toy_traj())
    assert sink.retries == 2
    reader = sink if kind == "binary" else TrajectoryReader(sink.root)
    assert reader.read(0).obs.shape == (2, 3, 3)   # the retried write landed


@pytest.mark.parametrize("kind", ["binary", "dataset"])
def test_sink_retry_exhaustion_is_actionable(tmp_path, kind):
    sink = SinkSpec(kind=kind, root=str(tmp_path / "spill")).build()
    faults.configure({"sink_oserror": {"times": 99}})
    with pytest.raises(OSError, match="after 4 attempts"):
        sink.write(0, _toy_traj())
    assert not list((tmp_path / "spill").glob("traj_*"))
    if kind == "dataset":
        assert TrajectoryReader(sink.root).episodes == []


# ---------------------------------------------------------------------------
# train(): sinks, the interface, retries in health, rollback
# ---------------------------------------------------------------------------

ENV = EnvConfig(grid=GridConfig(res=6, dt=0.012, poisson_iters=30),
                steps_per_action=3, actions_per_episode=3, warmup_time=1.0)


def _cfg(episodes, **kw):
    return TrainConfig(env=ENV, ppo=PPOConfig(epochs=2, minibatches=2),
                       n_envs=2, episodes=episodes, seed=0, device="cpu",
                       **kw)


@pytest.fixture(scope="module")
def plain_run():
    return train(_cfg(2), log_fn=None)


def test_train_spills_every_episode_and_routes_the_interface(tmp_path,
                                                             plain_run):
    """A binary sink from ``TrainConfig.sink`` gets every episode; the
    interface sees every PPO batch; neither changes the run."""
    iface = MultiEnvInterface("optimized", str(tmp_path / "io"), 2,
                              flowfield_floats=100)
    captured = []
    health = {}
    hist, model = train(
        _cfg(2, sink=SinkSpec(kind="binary", root=str(tmp_path / "spill"))),
        log_fn=None, interface=iface, health=health,
        on_episode=lambda traj, m: captured.append(traj))
    assert iface.period == 2 and iface.bytes_moved > 0
    assert health["sink_retries"] == 0
    spill = FileSink(str(tmp_path / "spill"))
    for ep, traj in enumerate(captured):
        _assert_traj_equal(traj, spill.read(ep))
    ref_hist, ref_model = plain_run
    for f in ("reward", "cd", "cl"):
        np.testing.assert_array_equal(hist[f], ref_hist[f])
    for a, b in zip(model.parameters(), ref_model.parameters()):
        assert torch.equal(a, b)
    # an explicit sink= wins over cfg.sink
    mem = MemorySink()
    train(_cfg(1, sink=SinkSpec(kind="binary", root=str(tmp_path / "no"))),
          log_fn=None, sink=mem)
    assert mem.episodes == 1 and not (tmp_path / "no").exists()


def test_train_reports_sink_retries_and_exhaustion(tmp_path):
    faults.configure({"sink_oserror": {"times": 2}})
    health = {}
    d = str(tmp_path / "ck")
    train(_cfg(1, sink=SinkSpec(kind="dataset", root=str(tmp_path / "ds")),
               ckpt_dir=d, ckpt_every=1), log_fn=None, health=health)
    assert health["sink_retries"] == 2
    meta = ck.read_manifest(ck.latest_checkpoint(d))["metadata"]
    assert meta["health"]["sink_retries"] == 2
    assert TrajectoryReader(str(tmp_path / "ds")).episodes == [0]
    faults.configure({"sink_oserror": {"times": 99}})
    with pytest.raises(OSError, match="after 4 attempts"):
        train(_cfg(1, sink=SinkSpec(kind="binary",
                                    root=str(tmp_path / "fail"))),
              log_fn=None)


def test_rollback_carries_sink_retries_forward(tmp_path):
    """A watchdog rollback rebuilds the cfg-built sink; the retries of the
    rolled-back run's sink still count, once."""
    faults.configure({"sink_oserror": {"times": 1},
                      "watchdog": {"episode": 1}})
    health = {}
    hist, _ = train(_cfg(2, sink=SinkSpec(kind="dataset",
                                          root=str(tmp_path / "ds"))),
                    log_fn=None, health=health)
    assert health["rollbacks"] == 1 and health["sink_retries"] == 1
    assert len(hist["reward"]) == 2
    assert TrajectoryReader(str(tmp_path / "ds")).episodes == [0, 1]
