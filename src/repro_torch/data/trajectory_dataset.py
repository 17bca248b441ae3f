"""Sharded on-disk trajectory dataset: the durable end of the sink API.

Port of ``repro.data.trajectory_dataset``, on the same on-disk format, so
a dataset recorded by either package reads in the other.  Layout under
one dataset root::

    manifest.json      JSON index + run metadata (atomic tmp+os.replace)
    shard_00000.bin    [8-byte LE length][pack_arrays payload] records
    shard_00001.bin    ... (rotated at ``shard_max_bytes``)

The manifest is the single source of truth: it maps episode -> (shard,
offset, length, crc32) and records how many bytes of each shard are
committed.  A record is written and fsync'd before the manifest is
atomically replaced, so a SIGKILL at any point leaves either a fully
indexed record or ignorable tail bytes past the committed count, never a
corrupt dataset.  Payloads are the ``core.interface`` msgpack + fp32
codec.  This package has no zstd codec: a fresh dataset asked for 'zstd'
is written 'binary', and a dataset whose manifest says 'zstd' raises
``DatasetError`` when opened to read or to append, as the reference does
where zstandard is not installed.

``DatasetSink`` is the write side (a ``TrajectorySink``, selected with
``SinkSpec(kind='dataset', root=...)``); ``TrajectoryReader`` is the read
side, feeding recorded episodes to ``RolloutEngine.replay_sync``.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from repro_torch.ckpt.io import atomic_write_text, read_exact, retry_io
from repro_torch.core.interface import pack_arrays, unpack_arrays
from repro_torch.drl.engine import (SinkReadError, TrajectorySink,
                                    _check_codec, _traj_arrays,
                                    _traj_from_arrays)
from repro_torch.drl.rollout import Trajectory
from repro_torch.testing import faults

DATASET_SCHEMA = "repro.traj_dataset/v1"
MANIFEST_NAME = "manifest.json"
_LEN = struct.Struct("<Q")          # record framing: 8-byte LE payload length


class DatasetError(ValueError):
    """A trajectory dataset failed validation (missing / truncated /
    corrupt shard, schema or codec mismatch).  Messages name the dataset
    root and the offending shard."""


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.bin"


def _undecodable(root: Path, codec: str, action: str) -> DatasetError:
    return DatasetError(
        f"dataset at {root} was written with codec {codec!r}, which this "
        f"package cannot decode (its one codec is 'binary'; it has no zstd "
        f"codec); cannot {action}: re-record it with codec 'binary'")


class DatasetSink(TrajectorySink):
    """Append-only sharded writer.  Shard bytes are fsync'd before the
    manifest (the index) is atomically replaced, and readers never look
    past the manifest's committed byte counts.

    Reopening an existing dataset root resumes it: committed records are
    kept, and any un-indexed tail from a previous crash is overwritten."""

    def __init__(self, root: str, codec: str = "binary",
                 shard_max_bytes: int = 64 * 1024 * 1024,
                 process: Optional[int] = None):
        super().__init__()
        self.codec = _check_codec(codec)
        self.shard_max_bytes = int(shard_max_bytes)
        self.process = process
        # each concurrent runner owns a part{NNN} subdirectory (its own
        # shards and manifest) under the shared root
        self.root = Path(root) if process is None \
            else Path(root) / f"part{process:03d}"
        self.root.mkdir(parents=True, exist_ok=True)
        mpath = self.root / MANIFEST_NAME
        if mpath.exists():
            self._man = json.loads(mpath.read_text())
            if self._man.get("schema") != DATASET_SCHEMA:
                raise DatasetError(
                    f"not a trajectory dataset at {self.root}: manifest "
                    f"schema {self._man.get('schema')!r} != "
                    f"{DATASET_SCHEMA!r}")
            if self._man["codec"] != "binary":
                raise _undecodable(self.root, self._man["codec"], "append")
        else:
            self._man = {"schema": DATASET_SCHEMA, "codec": self.codec,
                         "metadata": {} if process is None
                         else {"process": process},
                         "episodes": {}, "shards": {}}
            self._flush_manifest()

    # -- manifest ------------------------------------------------------------

    def _flush_manifest(self) -> None:
        retry_io(lambda: atomic_write_text(
                     self.root / MANIFEST_NAME,
                     json.dumps(self._man, indent=1, sort_keys=True)),
                 path=self.root / MANIFEST_NAME, what="dataset manifest",
                 on_retry=self._count_retry)

    def annotate(self, **meta) -> None:
        """Record run-level metadata (``train_state.run_metadata``) in the
        manifest, so the dataset outlives the writing process."""
        self._man["metadata"].update(
            json.loads(json.dumps(meta, default=str)))
        self._flush_manifest()

    @property
    def metadata(self) -> Dict:
        return dict(self._man["metadata"])

    # -- shard append --------------------------------------------------------

    def _current_shard(self) -> str:
        shards = self._man["shards"]
        if shards:
            name = max(shards)
            if shards[name] < self.shard_max_bytes:
                return name
            return _shard_name(len(shards))
        return _shard_name(0)

    def _write(self, episode: int, traj: Trajectory) -> int:
        arrays = _traj_arrays(traj)
        blob = pack_arrays(arrays)
        name = self._current_shard()
        offset = self._man["shards"].get(name, 0)
        path = self.root / name

        def append():
            faults.maybe_fail_io(str(path))
            # r+b at the committed offset, not append mode: overwrites any
            # un-indexed tail a previous crash left, and makes a retried
            # attempt idempotent
            with open(path, "r+b" if path.exists() else "wb") as f:
                f.seek(offset)
                f.write(_LEN.pack(len(blob)))
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())

        retry_io(append, path=path,
                 what=f"dataset shard append (episode {episode})",
                 on_retry=self._count_retry)
        n = _LEN.size + len(blob)
        self._man["episodes"][str(episode)] = {
            "shard": name, "offset": offset, "length": len(blob),
            "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
            "shape": {f: list(a.shape) for f, a in arrays.items()},
        }
        self._man["shards"][name] = offset + n
        self._flush_manifest()          # the record is durable before indexed
        return n

    def cleanup(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


class TrajectoryReader:
    """Read side of the dataset: validates the manifest against the shard
    files, then serves ``read(episode) -> Trajectory`` of host float32
    arrays (what ``RolloutEngine.replay_sync`` consumes)."""

    def __init__(self, root: str, *, validate: bool = True):
        self.root = Path(root)
        mpath = self.root / MANIFEST_NAME
        if not mpath.exists():
            raise DatasetError(f"no trajectory dataset at {self.root}: "
                               f"missing {MANIFEST_NAME}")
        self._man = json.loads(mpath.read_text())
        if self._man.get("schema") != DATASET_SCHEMA:
            raise DatasetError(
                f"not a trajectory dataset at {self.root}: manifest schema "
                f"{self._man.get('schema')!r} != {DATASET_SCHEMA!r}")
        self.codec = self._man.get("codec", "binary")
        if self.codec != "binary":
            raise _undecodable(self.root, self.codec, "read")
        if validate:
            self.validate()

    # -- index ---------------------------------------------------------------

    @property
    def episodes(self) -> List[int]:
        return sorted(int(e) for e in self._man["episodes"])

    @property
    def metadata(self) -> Dict:
        return dict(self._man.get("metadata", {}))

    def _range(self) -> str:
        eps = self.episodes
        return (f"episodes {eps[0]}..{eps[-1]} ({len(eps)} recorded)"
                if eps else "no episodes")

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        """Cross-check the manifest against the shard files on disk: an
        episode indexing a shard absent from the shard table, a committed
        shard file that is missing, a shard shorter than its committed
        byte count."""
        shards = self._man["shards"]
        for ep, rec in self._man["episodes"].items():
            if rec["shard"] not in shards:
                raise DatasetError(
                    f"manifest/shard-count mismatch in {self.root}: episode "
                    f"{ep} references shard {rec['shard']} absent from the "
                    f"shard table ({len(shards)} shards listed)")
        for name, committed in shards.items():
            path = self.root / name
            if not path.exists():
                raise DatasetError(f"manifest references missing shard "
                                   f"{name} in {self.root}")
            size = path.stat().st_size
            if size < committed:
                raise DatasetError(
                    f"truncated shard {name} in {self.root}: manifest "
                    f"commits {committed} bytes, file has {size}")

    # -- record access -------------------------------------------------------

    def read(self, episode: int) -> Trajectory:
        rec = self._man["episodes"].get(str(episode))
        if rec is None:
            raise SinkReadError(
                f"sink holds no episode {episode}: dataset at {self.root} "
                f"(codec {self.codec!r}) has {self._range()}")
        name = rec["shard"]
        path = self.root / name
        if not path.exists():
            raise DatasetError(f"manifest references missing shard {name} "
                               f"in {self.root}")
        with open(path, "rb") as f:
            f.seek(rec["offset"])
            hdr = read_exact(f, _LEN.size, path,
                             f"episode {episode} record header",
                             error=DatasetError, kind="shard")
            (n,) = _LEN.unpack(hdr)
            if n != rec["length"]:
                raise DatasetError(
                    f"corrupted shard {name} in {self.root}: episode "
                    f"{episode} record header says {n} bytes, manifest "
                    f"says {rec['length']}")
            blob = read_exact(f, n, path, f"episode {episode} payload",
                              error=DatasetError, kind="shard")
        crc = zlib.crc32(blob) & 0xFFFFFFFF
        if crc != rec["crc32"]:
            raise DatasetError(
                f"crc32 mismatch in shard {name} of {self.root}: episode "
                f"{episode} stored {rec['crc32']:#010x}, computed "
                f"{crc:#010x}: shard bytes are corrupt")
        arrays, _ = unpack_arrays(blob)
        return _traj_from_arrays(arrays)

    def __iter__(self) -> Iterator[Trajectory]:
        for ep in self.episodes:
            yield self.read(ep)

    def __len__(self) -> int:
        return len(self._man["episodes"])
