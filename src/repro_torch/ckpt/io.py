"""Crash-atomic file I/O primitives of the checkpoint layer.

Port of ``repro.ckpt.io``.  The durability contract:

  * ``atomic_write_bytes``/``atomic_write_text``: data lands in
    ``<path>.tmp`` and is ``os.replace``d into place, so a SIGKILL mid-write
    leaves at most a stray ``.tmp``, never a truncated destination file.
  * ``byte_view``: zero-copy uint8 view of a C-contiguous array for crc32 /
    file writes (``memoryview.cast`` chokes on 0-sized shapes).
  * ``read_exact``: bounded read that raises the caller's error class with a
    message naming the file and what was being read, never returning a
    short buffer for the caller to trip over later.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, Optional, Type

import numpy as np


def retry_io(fn: Callable[[], object], *, path, what: str = "write",
             attempts: int = 4, backoff: float = 0.05,
             retry_on=(OSError,),
             on_retry: Optional[Callable[[int, Exception], None]] = None,
             sleep: Callable[[float], None] = time.sleep):
    """Run ``fn`` with bounded retry + exponential backoff on transient I/O.

    After ``attempts`` tries the last error is re-raised wrapped in an
    actionable ``OSError`` naming the path and the attempt count.
    ``on_retry(attempt, exc)`` is invoked before each re-try so callers can
    count recoveries."""
    last: Optional[Exception] = None
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as e:          # noqa: PERF203 - bounded, cold path
            last = e
            if attempt == attempts:
                break
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(backoff * (2 ** (attempt - 1)))
    raise OSError(
        f"{what} to {path} failed after {attempts} attempts "
        f"(last error: {last}); check disk space / filesystem health "
        f"before resuming") from last


def atomic_write_bytes(path, blob: bytes) -> int:
    """Write ``blob`` to ``path`` atomically (tmp + ``os.replace``).

    Returns the number of bytes written.  The parent directory is created
    when missing."""
    p = Path(path)
    tmp = Path(str(p) + ".tmp")
    tmp.parent.mkdir(parents=True, exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, p)
    return len(blob)


def atomic_write_text(path, text: str) -> int:
    """Atomic UTF-8 text write (tmp + ``os.replace``)."""
    return atomic_write_bytes(path, text.encode("utf-8"))


def byte_view(a: np.ndarray):
    """Zero-copy byte buffer of a C-contiguous array (crc + file write)."""
    return b"" if a.nbytes == 0 else a.reshape(-1).view(np.uint8).data


def read_exact(f, n: int, path, what: str,
               error: Type[Exception] = ValueError,
               kind: str = "file") -> bytes:
    """Read exactly ``n`` bytes or raise ``error`` naming ``path``/``what``."""
    buf = f.read(n)
    if len(buf) != n:
        raise error(
            f"truncated {kind} {path}: wanted {n} bytes for {what}, "
            f"file ended after {len(buf)}")
    return buf
