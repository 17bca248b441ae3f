"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in
``build/repro_torch_kernels/`` at the root of the checkout, named by a
digest of their sources and flags, so an unchanged source is never rebuilt
and an edited one always is.  Nothing is built when this module is
imported: :func:`load` builds on first use, :func:`build` builds several
sources in parallel (one ``nvcc`` process each).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# the kernel sources, each with the headers it includes
SOURCES = {
    "poisson_sor": ("poisson_sor.cu", "sor_slabs.cuh", "sor_packed.cuh",
                    "resident.cuh", "grid_sync.cuh", "cluster.cuh",
                    "common.cuh"),
    "fused_interval": ("fused_interval.cu", "sor_packed.cuh",
                       "resident.cuh", "grid_sync.cuh", "cluster.cuh",
                       "common.cuh"),
    "poisson_sor_full": ("poisson_sor_full.cu", "sor_slabs.cuh",
                         "sor_packed.cuh", "resident.cuh", "grid_sync.cuh",
                         "cluster.cuh", "common.cuh"),
    "flash_attention": ("flash_attention.cu", "common.cuh"),
    "wkv6": ("wkv6.cu", "cluster.cuh", "common.cuh"),
    # no TPU kernel: the CFD kernels' synchronisation floor (PERF.md)
    "sync_probe": ("sync_probe.cu", "resident.cuh", "grid_sync.cuh",
                   "cluster.cuh", "common.cuh"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME, "
                           "/usr/local/cuda and $PATH): the CUDA kernels "
                           "build only on a host with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, *,
          verbose: bool = False) -> Dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together; returns ``{name: library path}``.  With
    ``verbose`` the register/shared-memory report of ``-Xptxas -v`` is
    printed."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                           else []),
               "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        if verbose and out:
            print(f"[nvcc {n}]\n{out.strip()}")
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    if name not in _LIBS:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")
