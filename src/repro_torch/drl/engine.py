"""Rollout engine: collect -> values -> GAE -> flatten, then the PPO update
(the paper's Fig. 4 loop), synchronous or double-buffered, with offline
replay.

Port of the single-host paths of ``repro.drl.engine``.  ``run_sync``
alternates collect and update; ``run_async`` overlaps them (the paper's
§IV refinement): on the card the update runs on a second CUDA stream,
its pieces issued between the actions of the next episode's collect,
which reads a behaviour copy of the policy.  It also holds
the paper's §IV I/O refinement for trajectory spill, a pluggable
``TrajectorySink``: in memory, one binary file per episode (msgpack + raw
fp32, the ``core.interface`` codec), or the sharded on-disk dataset
(``repro_torch.data.trajectory_dataset``).  Sinks are selected with one
:class:`SinkSpec`, accepted by ``EngineConfig`` and ``TrainConfig``; the
old ``make_sink(mode, root)`` survives as a deprecated shim.  The files
are the reference's, so either package reads the other's.  This package
has no zstd codec: ``codec="zstd"`` writes the binary payload, as the
reference does where zstandard is not installed.

An ``EngineConfig.plan`` resolves through ``core.autotune.resolve_plan``
into a ("data", "model") mesh (``launch/mesh.py``) whose n_ranks the
engine adopts; a multi-rank plan runs each env's pressure solve as x-slabs
with halo messages (the "halo" backend, ``cfd/decomp.py``), every slab on
the env's device.  ``place_env_batch`` puts an env batch (fresh, or
restored from a checkpoint of another plan) on a mesh.
``EngineConfig.fleet`` is the reference's multi-process fleet mode
(``launch/distributed.py``): each process rolls out its shard of the env
batch on its own card, the trajectories are all-gathered over gloo on the
host, and the values, GAE and the PPO update run replicated on every
process over the full batch.  A fleet of a multi-rank plan steps its
shard on the halo backend: each process holds whole envs, so the slabs
and their halo messages never leave it.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import shutil
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.ckpt.io import atomic_write_bytes, retry_io
from repro_torch.core.interface import pack_arrays, unpack_arrays
from repro_torch.device import DeviceLike
from repro_torch.drl import networks, rollout
from repro_torch.drl.gae import gae_batch
from repro_torch.drl.ppo import (Batch, PPOConfig, make_optimizer,
                                 ppo_update, ppo_update_steps)
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
    """What the training loops carry from one episode to the next, handed
    to ``on_state`` after each episode: for ``run_sync``, checkpointing it
    (with the env batch every episode starts from) and re-entering with it
    reproduces the remaining episodes bit for bit."""
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
    n_ranks: int = 1          # grid shards per env over the "model" axis
    # hybrid placement: "auto" (measure + optimize via core.autotune), a
    # core.plan.ParallelPlan / (n_envs, n_ranks) pair, a ResolvedPlan, or
    # None (explicit mesh= / single device).  When set and no mesh is
    # passed, the engine builds its mesh from the resolved plan (which
    # checks the plan's workers exist) and adopts the plan's n_ranks.
    plan: Any = None
    # trajectory spill (SinkSpec); an explicit sink= to the engine wins
    sink: Optional[SinkSpec] = None
    # phase timing: synchronise the card's stream around collect and update
    # so ``engine.stats`` reports their real shares (off: the loop does not
    # wait for the card more than it must)
    timing: bool = False
    # multi-process fleet mode (repro_torch.launch.distributed): each
    # process rolls out its n_envs // P rows, the trajectories are
    # all-gathered to the host over gloo, and postprocess + the PPO update
    # run replicated on every process over the full batch (the drlfoam
    # runner/learner split: no gradient traffic).  Training is bitwise-
    # identical at every fleet size: the policy runs on one env at a time,
    # every process draws the whole batch's noise and takes its rows, and
    # the caller pins the fused kernel's cluster.  Sinks spill per-process
    # env shards.
    fleet: bool = False


# ---------------------------------------------------------------------------
# mesh placement (the twins of the reference's sharding helpers)
# ---------------------------------------------------------------------------

def env_state_specs(mesh) -> Tuple[Tuple, Tuple]:
    """(batch-only spec, batch+space spec) for env state leaves, as axis
    name tuples with the meaning of the reference's ``PartitionSpec``s:
    the env batch dim over "data", a grid field's x (last) dim over
    "model" when the plan uses n_ranks > 1.  Here the "model" split is
    the x-slab view the halo solve takes of each field
    (``cfd.decomp.to_slabs``)."""
    del mesh
    return ("data",), ("data", None, "model")


def mesh_spans_processes(mesh) -> bool:
    """True when the mesh's workers live on more than one fleet process."""
    if mesh is None:
        return False
    return len({int(p) for p in mesh.processes.flat}) > 1


def _tree_map(fn, x):
    """``fn`` on every tensor leaf of a nested (named) tuple; None stays."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple):
        parts = [_tree_map(fn, a) for a in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return fn(torch.as_tensor(x))


def shard_env_batch(mesh, st_b, n_ranks: int = 1):
    """Place a batched env state on ``mesh``: every leaf onto this
    process's device of the mesh.  An env's slabs share its device, so the
    "model" split of its grid fields (n_ranks) is the halo solve's view,
    not a copy; a fleet process holds the whole batch and steps its own
    rows (``RolloutEngine.rollout_local``).  Host arrays (a checkpoint)
    are copied over."""
    if n_ranks > 1 and mesh.shape["model"] != n_ranks:
        raise ValueError(f"n_ranks = {n_ranks} does not match the mesh's "
                         f"model axis {mesh.shape['model']}")
    device = mesh.local_device
    return _tree_map(lambda a: a.to(device), st_b)


def place_env_batch(mesh, st_b, n_ranks: int = 1):
    """Place a (possibly checkpoint-restored) env batch for the engine.

    With a mesh this is :func:`shard_env_batch`, the cross-plan resume
    step: a state saved under one ``ParallelPlan`` is put on whatever mesh
    the current plan resolved to.  Without a mesh the batch stays where
    it is (a restored one is loaded onto the run's device)."""
    if mesh is not None:
        return shard_env_batch(mesh, st_b, n_ranks)
    return st_b


def _tree_rows(x, rows: slice):
    """Rows ``rows`` of every tensor of a (nested NamedTuple) env batch."""
    return _tree_map(lambda a: a[rows], x)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _on_stream(stream):
    """Make ``stream`` this thread's current stream (no-op for None)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _draw_perms(n: int, epochs: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One update's epoch permutations, drawn as ``ppo_update`` draws them
    itself: the same calls in the same order, so the generator ends in the
    same state."""
    return torch.stack([torch.randperm(n, generator=generator)
                        for _ in range(epochs)])


class RolloutEngine:
    """``collect`` rolls the env batch for one episode and returns the
    flattened PPO ``Batch`` with its ``Trajectory``; ``run_sync`` alternates
    collect and update for a number of episodes, ``run_async`` overlaps
    them; ``replay_sync`` drives the sync update from recorded episodes.

    ``device`` is where an ``EngineConfig.plan`` is resolved and its
    devices counted; the loops themselves run on the model's device."""

    def __init__(self, env_step_fn: Callable, cfg: EngineConfig, *,
                 mesh=None, sink: Optional[TrajectorySink] = None,
                 obs_aux_fn: Optional[Callable] = None,
                 device: DeviceLike = "cuda"):
        self.env_step_fn = env_step_fn
        self.obs_aux_fn = obs_aux_fn
        self.resolved_plan = None
        if cfg.plan is not None:
            from repro_torch.core.autotune import resolve_plan
            from repro_torch.launch.mesh import mesh_for_plan
            # smoke probe: engine construction must not block on a
            # full-resolution timing sweep (ignored for explicit plans)
            self.resolved_plan = resolve_plan(cfg.plan, smoke=True,
                                              device=device)
            if mesh is None:
                mesh = mesh_for_plan(self.resolved_plan, device=device)
            if self.resolved_plan.n_ranks != cfg.n_ranks:
                cfg = dataclasses.replace(
                    cfg, n_ranks=self.resolved_plan.n_ranks)
        self.mesh = mesh
        if cfg.fleet:
            from repro_torch.launch.distributed import fleet_info
            if self.resolved_plan is None:
                raise ValueError("EngineConfig(fleet=True) needs a plan: "
                                 "the fleet spans the plan's data groups "
                                 "over the processes")
            procs = fleet_info().num_processes
            if cfg.n_envs % procs:
                raise ValueError(
                    f"fleet mode needs n_envs = {cfg.n_envs} divisible by "
                    f"the process count {procs} (each process owns an "
                    f"equal env shard)")
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
        kw.setdefault("device", env.device)
        return cls(env.env_step, cfg, **kw)

    def _clock(self, device: torch.device) -> float:
        """Host seconds, after this thread's stream has drained when timing
        is on (the other stream of ``run_async`` runs on)."""
        if self.cfg.timing and device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
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
                record: bool = True, on_action: Optional[Callable] = None
                ) -> Tuple[Batch, Trajectory]:
        """One episode of all N_envs environments from ``(st_b, obs_b)``.
        With ``record`` the episode goes to the sink (if any) under id
        ``self.episode``, which advances either way.  ``on_action(t)``
        runs after each action's env step is issued."""
        device = _model_device(model)
        t0 = self._clock(device)
        if self.cfg.fleet:
            traj = self._fleet_collect(model, st_b, obs_b, generator, noise,
                                       on_action)
        else:
            _, traj = rollout.rollout_batch(
                self.env_step_fn, model, st_b, obs_b, self.cfg.horizon,
                generator=generator, noise=noise, obs_aux_fn=self.obs_aux_fn,
                on_action=on_action)
        batch = self.postprocess(model, traj)
        if self.cfg.timing:
            self.stats["collect_s"] += self._clock(device) - t0
            self.stats["episodes"] += 1
        if record:
            self._sink_write(self.episode, traj)
        self.episode += 1
        return batch, traj

    # -- fleet mode ----------------------------------------------------------

    def _shard(self) -> Tuple[int, int]:
        """(first row, row count) of this process's env shard."""
        from repro_torch.launch.distributed import fleet_info
        info = fleet_info()
        per = self.cfg.n_envs // info.num_processes
        return info.process_id * per, per

    def rollout_local(self, model, st_b, obs_b, *,
                      generator: Optional[torch.Generator] = None,
                      noise=None, on_action: Optional[Callable] = None
                      ) -> Trajectory:
        """This process's rows of the fleet rollout, on its card: no
        all-gather, no postprocess, no sink (the no-comms twin of
        ``collect`` that separates contention from communication).
        ``st_b`` / ``obs_b`` and the noise are the full batch's: every
        process draws the whole batch's noise from ``generator`` (one
        ``(n_envs, act_dim)`` draw per action, as the single-process
        rollout draws it) and keeps its rows, so the generator ends in the
        same state at every fleet size."""
        lo, per = self._shard()
        if noise is None:
            act_dim = model.cfg.act_dim
            noise = torch.stack([networks.action_noise(
                (self.cfg.n_envs, act_dim), generator)
                for _ in range(self.cfg.horizon)], dim=1)
        rows = slice(lo, lo + per)
        _, traj = rollout.rollout_batch(
            self.env_step_fn, model, _tree_rows(st_b, rows), obs_b[rows],
            self.cfg.horizon, noise=noise[rows], obs_aux_fn=self.obs_aux_fn,
            on_action=on_action, per_env=True)
        return traj

    def _fleet_collect(self, model, st_b, obs_b, generator, noise,
                       on_action) -> Trajectory:
        """The local rollout, its rows copied to the host and all-gathered
        over gloo (one collective of every field's rows side by side), the
        full batch back on the card.  A multi-rank plan gathers the same
        rows: the slabs are a view the halo solve takes of each env's
        fields, and no field of the trajectory carries a rank dimension.
        Adds the rollout's and the gather's host seconds and the gathered
        bytes to ``stats``."""
        from repro_torch.launch.distributed import all_gather_rows
        device = _model_device(model)
        t0 = time.perf_counter()
        local = self.rollout_local(model, st_b, obs_b, generator=generator,
                                   noise=noise, on_action=on_action)
        fields = [(f, a) for f, a in zip(Trajectory._fields, local)
                  if a is not None]
        widths = [a[0].numel() for _, a in fields]
        host = torch.cat([a.detach().reshape(a.shape[0], -1)
                          .to(torch.float32).cpu() for _, a in fields], dim=1)
        t1 = time.perf_counter()
        full = all_gather_rows(host)
        t2 = time.perf_counter()
        out = {}
        for (f, a), part in zip(fields,
                                torch.split(full.to(device), widths, dim=1)):
            out[f] = part.reshape(full.shape[0], *a.shape[1:]).to(a.dtype)
        self.stats["rollout_s"] = self.stats.get("rollout_s", 0.0) + t1 - t0
        self.stats["gather_s"] = self.stats.get("gather_s", 0.0) + t2 - t1
        self.stats["gather_bytes"] = (self.stats.get("gather_bytes", 0)
                                      + full.numel() * full.element_size())
        return Trajectory(**out)

    def _sink_write(self, episode: int, traj: Trajectory) -> None:
        """Spill one episode; fleet runners write only THEIR env rows (the
        sink's per-process suffix or part dir keeps concurrent writers
        apart)."""
        if self.sink is None:
            return
        if self.cfg.fleet:
            lo, per = self._shard()
            if per != self.cfg.n_envs:
                traj = Trajectory(*(None if a is None else a[lo:lo + per]
                                    for a in traj))
        self.sink.write(episode, traj)

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

    def run_async(self, model, opt_state, ppo_cfg: PPOConfig, optimizer,
                  st_b, obs_b, episodes: int, *, generator=None,
                  step: int = 0, drain: bool = True,
                  noise: Optional[Sequence] = None,
                  perms: Optional[Sequence] = None,
                  on_episode: Optional[Callable] = None,
                  on_state: Optional[Callable] = None,
                  state_every: int = 1):
        """Double-buffered stale-gradient PPO, the reference's schedule.

        Episode *e* is collected with the learner's params after the update
        of episode *e-2*, while the update consuming episode *e-1*'s batch
        runs.  ``model`` is the learner: the update writes it in place, so
        the collect reads a behaviour copy, refreshed from the learner at
        the start of each episode once the previous update has finished.

        One host thread issues both.  The update is
        ``ppo.ppo_update_steps``, paused after each minibatch's gradients
        and after its parameter update; after each action of the collect
        the engine runs the update's next pauses, spread evenly over the
        episode's actions, so its host work fills the time the collect
        waits for the card.  On the card those pieces run on a second CUDA
        stream, and events order the streams both ways: the update waits
        for the refresh, which follows the batch it consumes, and the next
        refresh waits for the update.  (A worker thread issuing the update
        competes with the collect for the interpreter lock: both slow
        down, see ``chip_smoke.py`` phase 9.)

        The generator is drawn in one fixed order per episode: the pending
        update's permutations (``epochs`` calls of ``randperm``, as
        ``ppo_update`` draws them), then the collect's rollout noise; the
        drain's permutations come last.  ``noise[e]`` injects episode
        ``e``'s rollout noise and ``perms[e]`` the permutations of the
        update consuming episode ``e``'s batch; injected streams draw
        nothing.

        ``on_episode(traj, None)`` fires after each collect (the update's
        metrics are not waited for).  ``on_state(TrainCarry)`` fires every
        ``state_every`` episodes with the carry as it stands: the update
        issued this episode has finished (so a checkpoint never reads a
        half-written model), the batch just collected is not part of it.
        A resume from such a carry drops that one in-flight update.  One
        final ``on_state`` fires after the drain.  The sink writes each
        episode after the next update has been issued.  Only ``run_sync``
        offers a bitwise resume."""
        device = _model_device(model)
        cuda = device.type == "cuda"
        collect_stream = torch.cuda.current_stream(device) if cuda else None
        update_stream = torch.cuda.Stream(device) if cuda else None
        learner = list(model.state_dict().values())
        behaviour = copy.deepcopy(model)
        behaviour_t = list(behaviour.state_dict().values())
        pauses = 2 * ppo_cfg.epochs * ppo_cfg.minibatches
        horizon = self.cfg.horizon

        def event(stream):
            if stream is None:
                return None
            ev = torch.cuda.Event()
            ev.record(stream)
            return ev

        # the update in flight: its paused steps, the event its stream
        # waits for, pauses run, and (once finished) its result; ``held``
        # references its inputs until the caller's stream is ordered after
        # it, since freed earlier the caching allocator could hand their
        # memory to the collect while the update still reads them
        inflight: Dict[str, Any] = {}

        def dispatch(batch, episode):
            perm = (perms[episode] if perms is not None
                    else _draw_perms(batch.obs.shape[0], ppo_cfg.epochs,
                                     generator))
            inflight.update(
                steps=ppo_update_steps(ppo_cfg, optimizer, model, opt_state,
                                       batch, step, perms=perm),
                ready=event(collect_stream), paused=0, out=None,
                held=(batch, opt_state))

        def advance(upto):
            """Run the in-flight update on its stream until ``upto`` pauses
            have passed, or to its end."""
            if not inflight or inflight["out"] is not None:
                return
            with _on_stream(update_stream), torch.enable_grad():
                ready = inflight.pop("ready", None)
                if ready is not None:
                    update_stream.wait_event(ready)
                while inflight["paused"] < upto:
                    try:
                        next(inflight["steps"])
                    except StopIteration as done:
                        inflight["out"] = done.value
                        inflight["done"] = event(update_stream)
                        return
                    inflight["paused"] += 1

        def on_action(t):
            advance(-(-(t + 1) * pauses // horizon))

        def join():
            """Finish the in-flight update and order the caller's stream
            after it."""
            nonlocal opt_state, step
            if not inflight:
                return
            advance(pauses + 1)
            opt_state, step, _ = inflight["out"]
            if inflight["done"] is not None:
                collect_stream.wait_event(inflight["done"])
            inflight.clear()

        pending = None           # (batch, episode) awaiting its update
        spill = None             # (episode, traj) awaiting the sink
        returns = []
        try:
            for i in range(episodes):
                join()
                with torch.no_grad():
                    for b, t in zip(behaviour_t, learner):
                        b.copy_(t)
                if pending is not None:
                    dispatch(*pending)
                ep_id = self.episode
                batch, traj = self.collect(
                    behaviour, st_b, obs_b, generator=generator,
                    noise=None if noise is None else noise[i], record=False,
                    on_action=on_action)
                if spill is not None:
                    self._sink_write(*spill)
                pending, spill = (batch, i), (ep_id, traj)
                returns.append(float(torch.mean(torch.sum(traj.reward,
                                                          dim=1))))
                if on_episode is not None:
                    on_episode(traj, None)
                if on_state is not None and (i + 1) % max(1, state_every) \
                        == 0:
                    join()
                    on_state(TrainCarry(model, opt_state, step, generator))
            join()
            if drain and pending is not None:
                dispatch(*pending)
                join()
        finally:
            if inflight and cuda:
                # unwinding mid-update: nothing may reuse its inputs' memory
                # before its issued work is done
                collect_stream.wait_stream(update_stream)
        if spill is not None:
            self._sink_write(*spill)
        if on_state is not None and episodes > 0:
            # the carry after the drain: no update in flight, so a
            # checkpoint of it loses nothing
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
