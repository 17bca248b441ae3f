"""Rollout engine, synchronous path: collect -> values -> GAE -> flatten,
then the PPO update (the paper's Fig. 4 loop), with offline replay.

Port of the single-host sync path of ``repro.drl.engine``.  It also holds
the paper's §IV I/O refinement for trajectory spill, a pluggable
``TrajectorySink``: in memory, one binary file per episode (msgpack + raw
fp32, the ``core.interface`` codec), or the sharded on-disk dataset
(``repro_torch.data.trajectory_dataset``).  Sinks are selected with one
:class:`SinkSpec`, accepted by ``EngineConfig`` and ``TrainConfig``; the
old ``make_sink(mode, root)`` survives as a deprecated shim.  The files
are the reference's, so either package reads the other's.  This package
has no zstd codec: ``codec="zstd"`` writes the binary payload, as the
reference does where zstandard is not installed.

Meshes, the async double-buffered loop and fleet mode are not ported yet.
"""
from __future__ import annotations

import os
import shutil
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.ckpt.io import atomic_write_bytes, retry_io
from repro_torch.core.interface import pack_arrays, unpack_arrays
from repro_torch.drl import networks, rollout
from repro_torch.drl.gae import gae_batch
from repro_torch.drl.ppo import Batch, PPOConfig, make_optimizer, ppo_update
from repro_torch.drl.rollout import Trajectory
from repro_torch.testing import faults

_DRL_DIR = os.path.dirname(__file__)


# ---------------------------------------------------------------------------
# trajectory sinks: the paper's I/O strategies applied to trajectory spill
# ---------------------------------------------------------------------------

def _host_traj(traj) -> Trajectory:
    """Trajectory of tensors -> host numpy, one device-to-host copy per
    field; absent (None) fields stay None."""
    return Trajectory(*(None if a is None
                        else a.detach().cpu().numpy() if torch.is_tensor(a)
                        else np.asarray(a) for a in traj))


def _traj_arrays(traj: Trajectory) -> Dict[str, np.ndarray]:
    """The present fields of a host trajectory, by name (the payload)."""
    return {f: a for f, a in zip(Trajectory._fields, _host_traj(traj))
            if a is not None}


def _traj_from_arrays(arrays: Dict[str, np.ndarray]) -> Trajectory:
    return Trajectory(**{f: arrays[f] for f in Trajectory._fields
                         if f in arrays})


class SinkReadError(KeyError):
    """Raised when a sink is asked for an episode it does not hold.

    Subclasses ``KeyError``; the message names the sink, its root / codec
    and the episodes actually present."""


class TrajectorySink:
    """Receives each collected episode's trajectories.  The base class is a
    no-op (the paper's io-disabled upper bound); subclasses spill to memory
    or disk.

    Tracks ``bytes_written`` / ``time_spent`` (caller-visible seconds, the
    host copy included) so training loops can report the interface cost
    like ``core.interface``."""

    def __init__(self):
        self.episodes = 0
        self.bytes_written = 0
        self.time_spent = 0.0
        self.retries = 0      # transient write errors recovered by retry

    def write(self, episode: int, traj: Trajectory) -> int:
        t0 = time.perf_counter()
        n = self._write(episode, traj)
        self.bytes_written += n
        self.time_spent += time.perf_counter() - t0
        self.episodes += 1
        return n

    def _write(self, episode: int, traj: Trajectory) -> int:
        return 0

    def read(self, episode: int) -> Trajectory:
        raise SinkReadError(f"sink holds no episode {episode}: "
                            f"{type(self).__name__} does not retain episodes")

    def annotate(self, **meta) -> None:
        """Attach run-level metadata (the run fingerprint).  A no-op for
        stateless sinks; the dataset sink records it in its manifest."""

    def close(self) -> None:
        """Flush and release handles; never destroys spilled data."""

    def cleanup(self) -> None:
        """Delete everything the sink spilled."""

    def _count_retry(self, attempt_no, exc) -> None:
        self.retries += 1


class MemorySink(TrajectorySink):
    """Keeps the last ``keep`` episodes on the host (replay / inspection)."""

    def __init__(self, keep: int = 8):
        super().__init__()
        self.keep = keep
        self._store: Dict[int, Trajectory] = {}

    def _write(self, episode: int, traj: Trajectory) -> int:
        host = _host_traj(traj)
        self._store[episode] = host
        while len(self._store) > self.keep:
            del self._store[min(self._store)]
        return sum(a.nbytes for a in host if a is not None)

    def read(self, episode: int) -> Trajectory:
        if episode not in self._store:
            have = (f"episodes {min(self._store)}..{max(self._store)}"
                    if self._store else "no episodes")
            raise SinkReadError(
                f"sink holds no episode {episode}: MemorySink(keep="
                f"{self.keep}) retains {have}")
        return self._store[episode]


def _check_codec(codec: str) -> str:
    """'binary' | 'zstd' -> the codec written: this package has no zstd
    codec, so 'zstd' writes 'binary'."""
    if codec not in ("binary", "zstd"):
        raise ValueError(f"unknown trajectory-sink codec {codec!r}; "
                         f"choose 'binary' or 'zstd'")
    return "binary"


class FileSink(TrajectorySink):
    """Spills each episode to one binary file through the
    ``core.interface`` codec (paper §III.D: a single binary file in place
    of many ASCII dumps).  Files land via tmp + ``os.replace``, so a
    SIGKILL mid-spill never leaves a truncated episode.

    ``codec`` is 'binary' (msgpack + raw fp32, the paper's optimized mode)
    or 'zstd', which writes 'binary' here (no zstd codec in this package).

    ``process`` suffixes every file with the writer's process id
    (``traj_000007.p002.bin``), so concurrent runners sharing one root
    never clobber each other's episodes.
    """

    def __init__(self, root: str, codec: str = "binary",
                 process: Optional[int] = None):
        super().__init__()
        self.codec = _check_codec(codec)
        self.process = process
        self.dir = Path(root)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, episode: int) -> Path:
        if self.process is None:
            return self.dir / f"traj_{episode:06d}.bin"
        return self.dir / f"traj_{episode:06d}.p{self.process:03d}.bin"

    def _write(self, episode: int, traj: Trajectory) -> int:
        # absent trailing fields (probe aux) are skipped, so files written
        # by either layout stay readable by both
        blob = pack_arrays(_traj_arrays(traj))
        path = self._path(episode)

        def attempt():
            faults.maybe_fail_io(str(path))
            return atomic_write_bytes(path, blob)

        return retry_io(attempt, path=path,
                        what=f"trajectory spill (episode {episode})",
                        on_retry=self._count_retry)

    def _available(self) -> str:
        pat = "traj_*.bin" if self.process is None \
            else f"traj_*.p{self.process:03d}.bin"
        eps = sorted(int(p.name.split("_")[1].split(".")[0])
                     for p in self.dir.glob(pat))
        return (f"episodes {eps[0]}..{eps[-1]} ({len(eps)} on disk)"
                if eps else "no episodes on disk")

    def read(self, episode: int) -> Trajectory:
        path = self._path(episode)
        if not path.exists():
            raise SinkReadError(
                f"sink holds no episode {episode}: FileSink(root="
                f"{str(self.dir)!r}, codec={self.codec!r}) has "
                f"{self._available()}")
        arrays, _ = unpack_arrays(path.read_bytes())
        return _traj_from_arrays(arrays)

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


@dataclass(frozen=True)
class SinkSpec:
    """One declarative config for every trajectory-spill strategy,
    accepted by ``EngineConfig.sink`` and ``TrainConfig.sink``.

      kind='none'     no spill (the paper's io-disabled upper bound)
      kind='memory'   MemorySink keeping the last ``keep`` episodes
      kind='binary'   FileSink, one msgpack+fp32 file per episode at ``root``
      kind='zstd'     FileSink asked for zstd: writes 'binary' here
      kind='dataset'  repro_torch.data.trajectory_dataset.DatasetSink:
                      sharded files + JSON manifest (``codec`` and
                      ``shard_max_bytes`` apply), the durable, replayable
                      format

    ``process`` makes file-backed sinks multi-process-safe: FileSink files
    get a per-process suffix and the dataset sink writes a per-process
    ``part{NNN}`` subdirectory under the shared root.  The default (None)
    takes the rank of an initialised ``torch.distributed`` group of more
    than one process, and the flat single-writer layout otherwise.
    """

    kind: str = "none"
    root: Optional[str] = None
    keep: int = 8                       # memory: episodes retained
    codec: str = "binary"               # dataset: payload codec
    shard_max_bytes: int = 64 * 1024 * 1024   # dataset: shard rotation
    process: Optional[int] = None

    KINDS = ("none", "memory", "binary", "zstd", "dataset")

    @classmethod
    def parse(cls, text: Optional[str]) -> "SinkSpec":
        """Parse a CLI-style ``kind[:root]`` string ('dataset:/tmp/ds')."""
        if text in (None, "", "none", "disabled"):
            return cls(kind="none")
        kind, _, root = text.partition(":")
        return cls(kind=kind, root=root or None)

    def _process(self) -> Optional[int]:
        if self.process is not None:
            return self.process
        dist = torch.distributed
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return dist.get_rank()
        return None

    def build(self) -> Optional[TrajectorySink]:
        if self.kind in (None, "none", "disabled"):
            return None
        if self.kind == "memory":
            return MemorySink(keep=self.keep)
        if self.kind in ("binary", "zstd"):
            if self.root is None:
                raise ValueError(f"file sink {self.kind!r} needs a root "
                                 f"directory")
            return FileSink(self.root, codec=self.kind,
                            process=self._process())
        if self.kind == "dataset":
            if self.root is None:
                raise ValueError("dataset sink needs a root directory")
            from repro_torch.data.trajectory_dataset import DatasetSink
            return DatasetSink(self.root, codec=self.codec,
                               shard_max_bytes=self.shard_max_bytes,
                               process=self._process())
        raise ValueError(f"unknown sink kind {self.kind!r}; "
                         f"choose from {self.KINDS}")


def make_sink(mode: str, root: Optional[str] = None
              ) -> Optional[TrajectorySink]:
    """Deprecated: pass ``SinkSpec(kind=..., root=...)`` (or
    ``SinkSpec.parse('binary:/path')``) instead.  The warning names the
    first caller outside this package's ``drl`` directory."""
    warnings.warn("make_sink() is deprecated; pass SinkSpec(kind=..., "
                  "root=...) / SinkSpec.parse('binary:/path') instead",
                  DeprecationWarning, skip_file_prefixes=(_DRL_DIR,))
    if mode in (None, "none", "disabled"):
        return None
    if mode == "memory":
        return MemorySink()
    if mode not in ("binary", "zstd"):
        raise ValueError(f"unknown sink mode {mode!r}; choose 'none', "
                         f"'memory', 'binary' or 'zstd'")
    if root is None:
        raise ValueError(f"file sink {mode!r} needs a root directory")
    return SinkSpec(kind=mode, root=root).build()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class TrainCarry(NamedTuple):
    """What ``run_sync`` carries from one episode to the next, handed to
    ``on_state`` after each update: checkpointing it (with the env batch
    every episode starts from) and re-entering with it reproduces the
    remaining episodes bit for bit."""
    model: torch.nn.Module
    opt_state: dict
    step: int
    generator: Optional[torch.Generator]


@dataclass(frozen=True)
class EngineConfig:
    n_envs: int
    horizon: int              # actuation periods per episode (the paper's T)
    gamma: float = 0.99
    lam: float = 0.95
    # trajectory spill (SinkSpec); an explicit sink= to the engine wins
    sink: Optional[SinkSpec] = None
    # phase timing: synchronise the card around collect and update so
    # ``engine.stats`` reports their real shares (off: the loop does not
    # wait for the card more than it must)
    timing: bool = False


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


class RolloutEngine:
    """``collect`` rolls the env batch for one episode and returns the
    flattened PPO ``Batch`` with its ``Trajectory``; ``run_sync`` alternates
    collect and update for a number of episodes; ``replay_sync`` drives the
    same update from recorded episodes."""

    def __init__(self, env_step_fn: Callable, cfg: EngineConfig, *,
                 sink: Optional[TrajectorySink] = None,
                 obs_aux_fn: Optional[Callable] = None):
        self.env_step_fn = env_step_fn
        self.obs_aux_fn = obs_aux_fn
        self.cfg = cfg
        if sink is None and cfg.sink is not None:
            sink = cfg.sink.build()
        self.sink = sink
        self.episode = 0
        self.stats = {"collect_s": 0.0, "update_s": 0.0, "episodes": 0}

    @classmethod
    def for_env(cls, env, cfg: EngineConfig, **kw) -> "RolloutEngine":
        """Bind a CylinderEnv-like object; its ``obs_aux`` (probe coords +
        live-slot mask) is threaded to the policy."""
        kw.setdefault("obs_aux_fn", getattr(env, "obs_aux", None))
        return cls(env.env_step, cfg, **kw)

    def _clock(self, device: torch.device) -> float:
        """Host seconds, after the card has drained when timing is on."""
        if self.cfg.timing and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    @torch.no_grad()
    def postprocess(self, model, traj: Trajectory) -> Batch:
        """values -> GAE -> flatten: shared verbatim by the live collect and
        ``replay_sync``, which is what makes a replay bitwise."""
        cfg = self.cfg
        if traj.probe_mask is not None:
            aux_t = {"xy": traj.probe_xy[:, None],
                     "mask": traj.probe_mask[:, None]}
            aux_n = {"xy": traj.probe_xy, "mask": traj.probe_mask}
        else:
            aux_t = aux_n = None
        values = networks.value(model, traj.obs, aux_t)          # (N, T)
        last_v = networks.value(model, traj.last_obs, aux_n)     # (N,)
        adv, ret = gae_batch(traj.reward, values, last_v, gamma=cfg.gamma,
                             lam=cfg.lam, valid=traj.valid)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        batch = Batch(obs=flat(traj.obs), act=flat(traj.act),
                      logp_old=flat(traj.logp), adv=flat(adv),
                      ret=flat(ret))
        if traj.valid is not None:
            batch = batch._replace(valid=flat(traj.valid))
        if traj.probe_mask is not None:
            N, T = traj.obs.shape[:2]
            xy = traj.probe_xy[:, None].expand(N, T, *traj.probe_xy.shape[1:])
            m = traj.probe_mask[:, None].expand(N, T,
                                                *traj.probe_mask.shape[1:])
            batch = batch._replace(probe_xy=flat(xy), probe_mask=flat(m))
        return batch

    def collect(self, model, st_b, obs_b, *,
                generator: Optional[torch.Generator] = None, noise=None,
                record: bool = True) -> Tuple[Batch, Trajectory]:
        """One episode of all N_envs environments from ``(st_b, obs_b)``.
        With ``record`` the episode goes to the sink (if any) under id
        ``self.episode``, which advances either way."""
        device = _model_device(model)
        t0 = self._clock(device)
        _, traj = rollout.rollout_batch(self.env_step_fn, model, st_b, obs_b,
                                        self.cfg.horizon,
                                        generator=generator, noise=noise,
                                        obs_aux_fn=self.obs_aux_fn)
        batch = self.postprocess(model, traj)
        if self.cfg.timing:
            self.stats["collect_s"] += self._clock(device) - t0
            self.stats["episodes"] += 1
        if record and self.sink is not None:
            self.sink.write(self.episode, traj)
        self.episode += 1
        return batch, traj

    def _update(self, ppo_cfg, optimizer, model, opt_state, batch, step,
                generator, perm):
        device = _model_device(model)
        t0 = self._clock(device)
        out = ppo_update(ppo_cfg, optimizer, model, opt_state, batch, step,
                         generator=generator, perms=perm)
        if self.cfg.timing:
            self.stats["update_s"] += self._clock(device) - t0
        return out

    def run_sync(self, model, opt_state, ppo_cfg: PPOConfig, optimizer,
                 st_b, obs_b, episodes: int, *, generator=None, step: int = 0,
                 noise: Optional[Sequence] = None,
                 perms: Optional[Sequence] = None,
                 on_batch: Optional[Callable] = None,
                 on_episode: Optional[Callable] = None,
                 on_state: Optional[Callable] = None):
        """Sequential [collect] -> [update]; every episode starts from
        ``(st_b, obs_b)``, as in the reference.  ``noise[e]`` /
        ``perms[e]`` inject episode ``e``'s rollout noise and PPO
        permutations.  ``step`` seeds the PPO minibatch counter (a resume
        passes the stored one).  ``on_batch(batch) -> batch`` runs between
        collect and update (the CFD<->DRL file interface).  After each
        update ``on_episode(traj, metrics)`` fires, then
        ``on_state(TrainCarry)``: an episode that ``on_episode`` rejects by
        raising is never handed to ``on_state``."""
        returns = []
        for e in range(episodes):
            batch, traj = self.collect(
                model, st_b, obs_b, generator=generator,
                noise=None if noise is None else noise[e])
            if on_batch is not None:
                batch = on_batch(batch)
            opt_state, step, metrics = self._update(
                ppo_cfg, optimizer, model, opt_state, batch, step, generator,
                None if perms is None else perms[e])
            returns.append(float(torch.mean(torch.sum(traj.reward, dim=1))))
            if on_episode is not None:
                on_episode(traj, metrics)
            if on_state is not None:
                on_state(TrainCarry(model, opt_state, step, generator))
        return model, opt_state, np.asarray(returns)

    def replay_sync(self, reader, model, opt_state, ppo_cfg: PPOConfig,
                    optimizer, episodes: int, *, generator=None,
                    step: int = 0, start: int = 0,
                    on_batch: Optional[Callable] = None,
                    on_state: Optional[Callable] = None,
                    perms: Optional[Sequence] = None):
        """Offline PPO: drive the sync update from recorded episodes
        ``start .. start + episodes - 1``.

        ``reader`` is anything with ``read(episode) -> Trajectory`` (a
        ``TrajectoryReader``, ``FileSink`` or ``MemorySink``).  Each episode
        is rebuilt on the model's device as float32 tensors, the live
        ``Trajectory``'s dtype for every field (the codec stores float32).
        Values and GAE are recomputed with the current params through the
        live path's ``postprocess``, and the generator is advanced as
        ``run_sync`` advances it: the episode's rollout noise is burned
        (``networks.burn_action_noise``), then ``ppo_update`` draws its
        permutations.  So replaying a just-recorded dataset from the
        recorded seed reproduces the live run's updates bit for bit.
        ``perms[e]`` (e counted from the replay's first episode) injects
        the permutations; then nothing is drawn and nothing burned."""
        device = _model_device(model)
        returns = []
        for e, ep in enumerate(range(start, start + episodes)):
            traj = Trajectory(*(
                None if a is None else torch.tensor(
                    np.asarray(a), dtype=torch.float32, device=device)
                for a in reader.read(ep)))
            if perms is None:
                N, T, act_dim = traj.act.shape
                networks.burn_action_noise(N, act_dim, T, generator)
            batch = self.postprocess(model, traj)
            if on_batch is not None:
                batch = on_batch(batch)
            opt_state, step, _ = self._update(
                ppo_cfg, optimizer, model, opt_state, batch, step, generator,
                None if perms is None else perms[e])
            returns.append(float(torch.mean(torch.sum(traj.reward, dim=1))))
            if on_state is not None:
                on_state(TrainCarry(model, opt_state, step, generator))
        return model, opt_state, np.asarray(returns)

    def init(self, pcfg: networks.PolicyConfig, ppo_cfg: PPOConfig,
             seed: int, device="cuda"):
        """(model, optimizer, opt_state, generator) for a fresh run."""
        generator = torch.Generator().manual_seed(seed)
        model = networks.init_actor_critic(pcfg, generator, device=device)
        optimizer = make_optimizer(ppo_cfg)
        opt_state = optimizer.init(list(model.parameters()))
        return model, optimizer, opt_state, generator
