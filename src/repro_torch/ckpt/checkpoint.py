"""Checkpointing: a tree of arrays to one file and back, stdlib + numpy.

Port of ``repro.ckpt.checkpoint``.  One file per checkpoint holds a
manifest (leaf paths, shapes, dtypes, per-leaf crc32, the caller's
metadata) followed by the raw array buffers.  The reference writes its
manifest with msgpack and compresses with zstd; the port writes the
manifest as JSON and compresses with ``zlib``, so it needs nothing beyond
the standard library and numpy.  Its files start with a magic of their own
(:data:`MAGIC`): the reference's loader refuses them on the magic, and the
port's loader refuses the reference's (``REPRO_CKPT_V1``) with an error
that names them as the JAX package's and points at
``repro_torch.convert.train_state_from_numpy``.  Every load-time failure
raises ``CheckpointError`` (a ``ValueError``) naming the offending leaf,
never a garbage tree.

A tree is nested dicts / lists / tuples (NamedTuples by field name) whose
leaves are numpy arrays, torch tensors or scalars; a leaf's path is its
keys joined by ``/``.  ``None`` leaves are dropped.  ``restore`` returns
numpy arrays.

Directory layout (``save_step`` / ``latest_checkpoint`` / ``AsyncCheckpointer``):

    ckpt_dir/
      step_00000010.ckpt     one file per retained step
      step_00000020.ckpt
      LATEST                 name of the newest complete checkpoint

Writes are crash-atomic: data lands in ``<path>.tmp`` and is ``os.replace``d
into place, and the ``LATEST`` pointer is updated the same way, so a SIGKILL
mid-save leaves at most a stray ``.tmp``, never a truncated ``.ckpt``.
``latest_checkpoint`` still validates candidates (newest first, crc32
included), so an externally corrupted file is skipped, not loaded.

``AsyncCheckpointer`` copies every tensor to host memory on the caller's
thread and serializes and writes on a background thread, so a save
overlaps the next episode's collection.
"""
from __future__ import annotations

import json
import os
import time
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.io import atomic_write_text, byte_view, read_exact
from repro_torch.testing import faults

MAGIC = b"REPRO_TORCH_CKPT_V1"
REFERENCE_MAGIC = b"REPRO_CKPT_V1"   # the JAX package's checkpoints
LATEST_NAME = "LATEST"
ZLIB_LEVEL = 1
_CHUNK = 1 << 20          # streaming-restore granularity (1 MiB)


class CheckpointError(ValueError):
    """A checkpoint could not be read/matched; the message names the file
    and (when applicable) the offending leaf path."""


def _flatten_with_paths(tree) -> Dict[str, Any]:
    """``{"a/b/0/c": leaf}`` of a nested dict / list / tuple tree."""
    out: Dict[str, Any] = {}

    def walk(node, path):
        if node is None:
            return
        if hasattr(node, "_asdict"):          # NamedTuple: by field name
            node = node._asdict()
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(tree, ())
    return out


def host_array(v, *, copy: bool = False) -> np.ndarray:
    """A leaf as a C-contiguous host ndarray; ``copy=True`` never aliases
    the caller's memory (a CPU tensor's ``.cpu()`` would)."""
    if torch.is_tensor(v):
        v = v.detach()
        a = (v.to("cpu", copy=True) if copy else v.cpu()).numpy()
    else:
        a = np.array(v, copy=copy) if copy else np.asarray(v)
    # NB: np.ascontiguousarray would promote 0-d to (1,)
    return a if a.flags["C_CONTIGUOUS"] else a.copy(order="C")


def save(path: str, tree: Any, *, step: int = 0, compress: bool = True,
         metadata: Optional[Dict] = None) -> int:
    """Write a checkpoint atomically; returns bytes written.

    ``metadata`` must be JSON-serializable (plain dict/list/str/num); it
    rides in the manifest and comes back from ``restore``/``read_manifest``.
    """
    arrays = {k: host_array(v) for k, v in _flatten_with_paths(tree).items()}
    manifest = {
        "step": step,
        "metadata": metadata or {},
        "arrays": {k: {"shape": list(a.shape),
                       "dtype": str(a.dtype),
                       "crc32": zlib.crc32(byte_view(a))}
                   for k, a in arrays.items()},
        "compressed": bool(compress),
    }
    tmp = Path(str(path) + ".tmp")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        mb = json.dumps(manifest).encode("utf-8")
        f.write(MAGIC)
        f.write(len(mb).to_bytes(8, "little"))
        f.write(mb)
        n = len(MAGIC) + 8 + len(mb)
        for k in sorted(arrays):
            buf = byte_view(arrays[k])     # zero-copy
            if compress:
                buf = zlib.compress(buf, ZLIB_LEVEL)
            f.write(len(buf).to_bytes(8, "little"))
            f.write(buf)
            n += 8 + len(buf)
    # fault-injection point (repro_torch.testing.faults, "ckpt_crash"):
    # dying HERE leaves a complete .tmp but no destination, the torn-write
    # shape latest_checkpoint's deep validation must skip over
    faults.maybe_crash_ckpt(step if step is not None else -1, str(path))
    os.replace(tmp, path)
    return n


def _read_exact(f, n: int, path, what: str) -> bytes:
    return read_exact(f, n, path, what, error=CheckpointError,
                      kind="checkpoint")


def _read_header(f, path) -> Dict:
    head = f.read(len(MAGIC))
    if head != MAGIC:
        if head.startswith(REFERENCE_MAGIC):
            raise CheckpointError(
                f"{path} is a checkpoint of the JAX package (repro.ckpt, "
                f"magic {REFERENCE_MAGIC.decode()}), not of repro_torch: "
                f"read its tree on the JAX side (repro.ckpt.checkpoint."
                f"restore, then repro.drl.train_state._nest) and carry it "
                f"across with repro_torch.convert.train_state_from_numpy")
        raise CheckpointError(f"not a repro_torch checkpoint: {path}")
    mlen = int.from_bytes(_read_exact(f, 8, path, "manifest length"),
                          "little")
    try:
        manifest = json.loads(_read_exact(f, mlen, path, "manifest"))
    except ValueError as e:
        raise CheckpointError(
            f"corrupted checkpoint {path}: manifest unreadable ({e})") from e
    if not isinstance(manifest, dict) or "arrays" not in manifest:
        raise CheckpointError(
            f"corrupted checkpoint {path}: manifest has no array table")
    return manifest


def _read_leaf(f, path, key: str, spec: Dict, compressed: bool
               ) -> np.ndarray:
    """Read one array segment, streaming uncompressed data in chunks
    directly into the destination buffer (bounded memory for large leaves)."""
    blen = int.from_bytes(_read_exact(f, 8, path, f"length of {key!r}"),
                          "little")
    shape = tuple(spec["shape"])
    try:
        dtype = np.dtype(spec["dtype"])
    except TypeError as e:
        raise CheckpointError(f"checkpoint {path}: leaf {key!r} has an "
                              f"unknown dtype {spec['dtype']!r}") from e
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    arr = np.empty(shape, dtype)
    dst = memoryview(arr.reshape(-1).view(np.uint8))
    if compressed:
        raw = _read_exact(f, blen, path, f"data of {key!r}")
        d = zlib.decompressobj()
        try:
            buf = d.decompress(raw, max(nbytes, 1))
        except zlib.error as e:
            raise CheckpointError(
                f"corrupted checkpoint {path}: leaf {key!r} fails to "
                f"decompress ({e})") from e
        if len(buf) != nbytes or d.unconsumed_tail or not d.eof:
            raise CheckpointError(
                f"corrupted checkpoint {path}: leaf {key!r} does not "
                f"decompress to the manifest's {nbytes} bytes")
        dst[:] = buf
    else:
        if blen != nbytes:
            raise CheckpointError(
                f"corrupted checkpoint {path}: leaf {key!r} holds {blen} "
                f"bytes, manifest shape/dtype need {nbytes}")
        off = 0
        while off < nbytes:
            got = f.readinto(dst[off:off + _CHUNK])
            if not got:
                raise CheckpointError(
                    f"truncated checkpoint {path}: leaf {key!r} ended "
                    f"after {off}/{nbytes} bytes")
            off += got
    crc = spec.get("crc32")
    if crc is not None and zlib.crc32(dst) != crc:   # buffer view, no copy
        raise CheckpointError(
            f"corrupted checkpoint {path}: leaf {key!r} fails its crc32 "
            f"integrity check")
    return arr


def read_manifest(path: str) -> Dict:
    """Header-only read: the manifest dict (step, metadata, array table)."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def validate(path: str, *, deep: bool = False) -> Dict:
    """Raise ``CheckpointError`` unless ``path`` is a complete checkpoint.

    Shallow (default): header parses and every array segment is fully
    present (length bookkeeping vs. file size).  ``deep=True`` additionally
    reads every leaf and verifies its crc32.  Returns the manifest."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        manifest = _read_header(f, path)
        compressed = bool(manifest.get("compressed"))
        for k in sorted(manifest["arrays"]):
            if deep:
                _read_leaf(f, path, k, manifest["arrays"][k], compressed)
                continue
            blen = int.from_bytes(
                _read_exact(f, 8, path, f"length of {k!r}"), "little")
            end = f.seek(blen, os.SEEK_CUR)
            if end > size:
                raise CheckpointError(
                    f"truncated checkpoint {path}: leaf {k!r} extends past "
                    f"end of file")
    return manifest


def restore(path: str, target: Any = None, *, cast: bool = False) -> Any:
    """Load a checkpoint.

    Without ``target``: returns ``(arrays, manifest)`` where ``arrays`` maps
    flattened leaf paths to host ndarrays.

    With ``target``: validates structure, per-leaf shape AND dtype against
    the target tree and returns ``{path: ndarray}`` in the target's leaf
    order.  A dtype mismatch raises ``CheckpointError`` naming the leaf
    unless ``cast=True`` (explicit opt-in to convert)."""
    with open(path, "rb") as f:
        manifest = _read_header(f, path)
        compressed = bool(manifest.get("compressed"))
        arrays = {k: _read_leaf(f, path, k, manifest["arrays"][k],
                                compressed)
                  for k in sorted(manifest["arrays"])}
    if target is None:
        return arrays, manifest
    tgt = _flatten_with_paths(target)
    missing, extra = set(tgt) - set(arrays), set(arrays) - set(tgt)
    if missing or extra:
        raise CheckpointError(
            f"checkpoint {path} does not match the target tree: "
            f"missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    out = {}
    for key, leaf in tgt.items():
        arr, want = arrays[key], host_array(leaf)
        if arr.shape != want.shape:
            raise CheckpointError(
                f"checkpoint {path}: leaf {key!r} has shape {arr.shape}, "
                f"target wants {want.shape}")
        if arr.dtype != want.dtype:
            if not cast:
                raise CheckpointError(
                    f"checkpoint {path}: leaf {key!r} has dtype "
                    f"{arr.dtype}, target wants {want.dtype} "
                    f"(pass cast=True to convert)")
            arr = arr.astype(want.dtype)
        out[key] = arr
    return out


# ---------------------------------------------------------------------------
# directory layout: step files + LATEST pointer + retention
# ---------------------------------------------------------------------------

def step_path(ckpt_dir: str, step: int) -> Path:
    return Path(ckpt_dir) / f"step_{step:08d}.ckpt"


def _point_latest(ckpt_dir: Path, name: str) -> None:
    atomic_write_text(ckpt_dir / LATEST_NAME, name + "\n")


def save_step(ckpt_dir: str, step: int, tree: Any, *,
              keep: Optional[int] = None, compress: bool = True,
              metadata: Optional[Dict] = None) -> str:
    """Write ``step_<step>.ckpt`` under ``ckpt_dir``, repoint ``LATEST``,
    and (with ``keep``) delete all but the newest ``keep`` step files.
    Returns the checkpoint path."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = step_path(ckpt_dir, step)
    save(str(path), tree, step=step, compress=compress, metadata=metadata)
    _point_latest(d, path.name)
    if keep is not None and keep > 0:
        for old in sorted(d.glob("step_*.ckpt"))[:-keep]:
            if old != path:
                old.unlink(missing_ok=True)
    return str(path)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Path of the newest checkpoint that validates, or None.

    Step files are tried newest-first (their zero-padded names sort
    chronologically), so a crash in ``save_step``'s window between writing
    the step file and repointing ``LATEST`` still resumes from the newest
    complete checkpoint.  The pointer is only a fallback hint for files the
    ``step_*`` glob cannot see.  Candidates get a deep (crc-verifying)
    validation: a resume happens once per restart, and falling back past a
    damaged file beats aborting on it."""
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    cands = sorted(d.glob("step_*.ckpt"), reverse=True)
    ptr = d / LATEST_NAME
    if ptr.exists():
        try:
            p = d / ptr.read_text().strip()
            if p.exists() and p not in cands:
                cands.append(p)
        except OSError:  # pragma: no cover - unreadable pointer
            pass
    for c in cands:
        try:
            validate(str(c), deep=True)
            return str(c)
        except (CheckpointError, OSError):
            continue
    return None


def latest_step(ckpt_dir: str) -> Optional[str]:
    """Alias of :func:`latest_checkpoint`, as in the reference."""
    return latest_checkpoint(ckpt_dir)


# ---------------------------------------------------------------------------
# async saves: host snapshot now, disk write in the background
# ---------------------------------------------------------------------------

class AsyncCheckpointer:
    """Periodic checkpoint writer whose disk I/O hides behind compute.

    ``save(step, tree)`` blocks only for (a) the previous write to finish
    (at most one in flight, bounding host memory to one snapshot) and
    (b) the host snapshot: every tensor copied to host memory
    (``.detach()`` then a copy to the CPU), which must complete before
    training mutates it.  ``ppo_update`` writes the params and the Adam
    moments in place, so a snapshot that still aliased them would save the
    next episode's values.  Serialization and the disk write then run on
    one worker thread while the caller runs the next episode.

    A failed background write surfaces as an exception from the NEXT
    ``save``/``wait``/``close`` call, never silently dropped.
    """

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 compress: bool = True, background: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.compress = compress
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt")
                      if background else None)
        self._inflight: Optional[Future] = None
        self.saves = 0
        self.bytes_written = 0
        self.time_blocked = 0.0      # caller-visible stall (snapshot + waits)
        self.time_waited = 0.0       # the part spent on the previous write

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict] = None) -> None:
        t0 = time.perf_counter()
        self.wait()                        # <=1 write in flight; raise errors
        self.time_waited += time.perf_counter() - t0
        host = {k: host_array(v, copy=True)
                for k, v in _flatten_with_paths(tree).items()}
        if self._pool is not None:
            self._inflight = self._pool.submit(self._write, step, host,
                                               metadata)
        else:
            self._write(step, host, metadata)
        self.time_blocked += time.perf_counter() - t0
        self.saves += 1

    def _write(self, step: int, host_tree: Any,
               metadata: Optional[Dict]) -> None:
        path = save_step(str(self.dir), step, host_tree, keep=self.keep,
                         compress=self.compress, metadata=metadata)
        self.bytes_written += os.path.getsize(path)

    def wait(self) -> None:
        """Block until the in-flight write lands; re-raises its error."""
        if self._inflight is not None:
            fut, self._inflight = self._inflight, None
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
