"""How a kernel spreads one problem over a thread-block cluster.

Shared by the kernels whose blocks each hold a band of rows of a plane in
shared memory and exchange halo rows through distributed shared memory
(``csrc/cluster.cuh``): the fused actuation interval
(``kernels/actuation/ops.py``) and the packed-SOR slab smoother
(``kernels/poisson/ops.py``).  Each kernel states its own per-block
shared-memory bytes; the partition, the block shape and the choice of
the cluster size are the same for both.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable

import torch

# the cluster sizes the kernels launch with (csrc/cluster.cuh kMaxCluster =
# 16; sizes above 8 are the card's non-portable ones)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def band_starts(ny: int, cluster: int) -> tuple:
    """The band partition of ``ny`` rows over a cluster: rank r owns rows
    ``[starts[r], starts[r + 1])``; rows per rank differ by at most one.
    The kernels take these starts as they are."""
    if not 1 <= cluster <= ny:
        raise ValueError(f"a cluster of {cluster} blocks cannot split "
                         f"{ny} rows")
    return tuple(r * ny // cluster for r in range(cluster + 1))


def rows_max(starts) -> int:
    """The most rows any rank of a partition owns."""
    return max(b - a for a, b in zip(starts, starts[1:]))


def block_shape(w: int, rows: int) -> tuple:
    """``(threads, tx)`` of a block: ``tx`` lanes (a multiple of 32) span a
    row of ``w`` columns, ``threads // tx`` thread rows step over the
    band's ``rows`` rows, at most 1024 threads."""
    tx = min(1024, 32 * -(-w // 32))
    return tx * max(1, min(rows, 1024 // tx)), tx


def fitting_clusters(ny: int, smem_of: Callable[[int], int],
                     smem_per_block: int) -> list:
    """The cluster sizes whose largest band of ``ny`` rows fits one block:
    ``smem_of(c)`` is the kernel's bytes per block at ``c`` blocks."""
    return [c for c in CLUSTER_SIZES
            if c <= ny and smem_of(c) <= smem_per_block]


def choose_cluster(fits: Iterable[int], n_groups: int, n_sm: int,
                   active: Dict[int, int]) -> int:
    """The cluster size for ``n_groups`` clusters (one per env, or per env
    and slab).

    ``fits`` are the sizes whose band fits one block (:func:`fitting_
    clusters`); ``active`` maps a size to how many such clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``), ``n_sm`` is its SM
    count: where two blocks fit one SM the card may hold more clusters than
    it has SMs for, and a size is taken only if every block of every group
    has an SM of its own.  The smallest fitting size is the floor; above
    it the largest of 16, 8, 4, 2 under which all ``n_groups`` clusters are
    resident at once, else the floor (the groups then run in waves, and
    fewer blocks per group waste fewest SMs)."""
    fits = sorted(fits)
    if not fits:
        raise ValueError(f"no cluster of up to {CLUSTER_SIZES[-1]} blocks "
                         f"holds the problem")
    for c in (16, 8, 4, 2):
        if (c in fits and n_groups * c <= n_sm
                and active.get(c, 0) >= n_groups):
            return c
    return fits[0]


_ACTIVE: Dict[tuple, int] = {}


def active_clusters(lib, query: str, dev, shape: tuple, cluster: int,
                    threads: int, smem: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` through a kernel library's
    ``query(cluster, threads, smem, int*)`` export, read once per card,
    launch ``shape`` and cluster size."""
    key = (query, shape, dev.index, cluster)
    if key not in _ACTIVE:
        from repro_torch.kernels.build import check_launch
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = getattr(lib, query)(cluster, threads, smem,
                                      ctypes.byref(n))
        check_launch(lib, err, f"{query} occupancy query")
        _ACTIVE[key] = n.value
    return _ACTIVE[key]
