"""How a kernel spreads one problem over a group of blocks.

Shared by the CFD kernels, each of which has three realizations: a
cluster kernel, whose blocks each hold a band of rows of a plane in shared
memory and exchange halo rows through distributed shared memory
(``csrc/cluster.cuh``); a resident kernel for the grids whose bands fit
one block only over more than one cluster, a group of G = K C blocks (K
clusters of C) holding the bands in shared memory, the halo rows through
distributed shared memory inside a cluster and through mirror slots in
global memory at the K - 1 cluster edges (``csrc/resident.cuh``); and a
global-memory kernel for every other grid, whose group of blocks splits
the rows of fields kept in a workspace in global memory and orders its
phases by flags (``csrc/grid_sync.cuh``).  The kernels are the fused
actuation interval (``kernels/actuation/ops.py``) and the two SOR slab
smoothers (``kernels/poisson/ops.py``).  Each states its own per-block
shared-memory and per-group workspace bytes; the partition, the block
shapes, the choice of the group size and the launch plan are the same for
all.  Which kernel serves a grid follows its shape alone; the plan within
a kernel follows the card's occupancy.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Iterable

import torch

# the cluster sizes the kernels launch with (csrc/cluster.cuh kMaxCluster =
# 16; sizes above 8 are the card's non-portable ones)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# the most blocks of one group of a global-memory kernel (csrc/grid_sync.cuh
# kMaxGroup): warp 0's lanes poll the group's flags and read its partial
# sums, a lane a block
GROUP_MAX = 32
# unsigned words between two blocks' flags (csrc/grid_sync.cuh kFlagStride)
FLAG_STRIDE = 32
# the resident kernels' groups, G blocks an env or (env, slab) (past the
# cluster kernel's 16, to GROUP_MAX, in steps of 8), and their clusters, C
# blocks each, K = G / C >= 2 a group (csrc/resident.cuh)
RESIDENT_GROUPS = (24, 32)
RESIDENT_CLUSTERS = (16, 8, 4, 2)


def packed_width(nx: int) -> int:
    """The packed checkerboard planes' width of an ``nx``-wide grid:
    ``nx // 2``, or ``(nx + 1) // 2`` on an odd width, where one plane's
    last slot on each row is dead, grid column ``nx`` (red's on odd rows,
    black's on even ones; ``csrc/sor_packed.cuh``)."""
    return (nx + 1) // 2


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


def resident_shape(w: int, rows: int) -> tuple:
    """``(threads, tx)`` of a block of a resident kernel, whose band lies
    in shared memory: ``tx`` lanes (a multiple of 32) span a row of ``w``
    columns and ``threads // tx`` thread rows stand side by side over the
    band's ``rows`` rows, at most 1024 threads, so that a thread's points
    in sequence, ``ceil(rows / thread rows) * ceil(w / tx)``, are fewest
    (ties: the fewer threads)."""
    best = None
    for tx in range(32, 32 * -(-min(w, 1024) // 32) + 1, 32):
        ty = max(1, min(rows, 1024 // tx))
        key = (-(-rows // ty) * -(-w // tx), tx * ty)
        if best is None or key < best[0]:
            best = (key, tx * ty, tx)
    return best[1], best[2]


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


def global_group(ny: int, n_groups: int, n_sm: int) -> int:
    """G, the blocks each of ``n_groups`` groups (one per env, or per env
    and slab) spreads over in a global-memory kernel: a block per SM while
    the groups leave SMs to spare, at most :data:`GROUP_MAX` and one row a
    block; one block a group when the groups outnumber the SMs."""
    return max(1, min(GROUP_MAX, ny, n_sm // max(1, n_groups)))


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How a call of a CFD kernel runs: ``kernel`` "cluster", "resident"
    or "global"; ``size`` the blocks of a group (the cluster size, or G,
    which orders the force sums as the cluster size does); ``per_launch``
    groups a launch, ``launches`` launches a call; ``workspace_bytes`` the
    resident or global-memory kernel's workspace, one launch's, reused by
    the next (0 for the cluster kernel); ``cluster`` the blocks of a
    thread-block cluster (the cluster kernel's ``size``, the resident
    kernel's C, 0 for the global-memory kernel, which has none)."""
    kernel: str
    size: int
    per_launch: int
    launches: int
    workspace_bytes: int
    cluster: int = 0


def resident_groups(ny: int, smem_of: Callable[[int], int],
                    smem_per_block: int) -> list:
    """The group sizes G of a resident kernel (:data:`RESIDENT_GROUPS`, G
    <= ``ny``) whose largest band of ``ny`` rows fits one block:
    ``smem_of(G)`` is the kernel's bytes per block at G (the cluster
    kernel's at G blocks)."""
    return [g for g in RESIDENT_GROUPS
            if g <= ny and smem_of(g) <= smem_per_block]


def mirror_floats(group: int, cluster: int, slots: int, width: int) -> int:
    """Floats of one group's mirror slots in a resident kernel's workspace
    (csrc/resident.cuh mirror_floats): K - 1 cluster edges, two directions,
    ``slots`` slots of ``width`` floats rounded up to 32 (a row of tagged
    words, a float and its phase each, takes two)."""
    return (group // cluster - 1) * 2 * slots * 32 * -(-width // 32)


def resident_plan(fits, n_groups: int, active,
                  workspace: Callable[[int, int, int], int], what: str,
                  size=None) -> LaunchPlan:
    """The launches of ``n_groups`` groups of a resident kernel: ``fits``
    the group sizes whose band fits one block (:func:`resident_groups`),
    ``active(C, G)`` the clusters of C blocks the card holds at once at the
    launch shape of G blocks a group, ``workspace(G, C, n)`` the workspace
    bytes of n groups.  Every cluster of a launch is resident at once (a
    group's K = G / C clusters wait for each other): a launch holds at most
    ``active(C, G) // K`` groups, and groups past it run in further
    launches of whole groups.  G (``size`` where given) and C (of
    :data:`RESIDENT_CLUSTERS`, K >= 2) are those of the fewest launches,
    then the largest C (fewest cluster edges; the fastest C on the card,
    ``chip_smoke.py`` phase 1 and PERF.md §6), then the largest G (fewest
    rows a block).  A size that does not fit, or a group the card cannot
    hold at all, raises."""
    if size is not None:
        if size not in fits:
            raise ValueError(f"{what}: a group of {size} blocks cannot hold "
                             f"it in shared memory; resident group sizes "
                             f"that fit: {fits}")
        fits = [size]
    best = None
    for g in fits:
        for c in RESIDENT_CLUSTERS:
            k = g // c
            if g % c or k < 2:
                continue
            per = min(n_groups, active(c, g) // k)
            if per < 1:
                continue
            key = (-(-n_groups // per), -c, -g)
            if best is None or key < best[0]:
                best = (key, g, c, per)
    if best is None:
        raise ValueError(
            f"{what}: the card holds too few clusters at once for one "
            f"resident group of any of the sizes {fits} (clusters of "
            + ", ".join(f"{c}: {active(c, g)} at G {g}" for g in fits
                        for c in RESIDENT_CLUSTERS if g % c == 0
                        and g // c >= 2) + ")")
    (launches, _, _), g, c, per = best
    return LaunchPlan("resident", g, per, launches, workspace(g, c, per), c)


def global_plan(n_groups: int, size: int, resident: int,
                workspace: Callable[[int], int], what: str) -> LaunchPlan:
    """The launches of ``n_groups`` groups of ``size`` blocks of a
    global-memory kernel, every block of a launch resident at once (a
    block waits for the others of its group): ``resident`` is how many
    blocks of the kernel the card holds at once, ``workspace(n)`` the
    workspace bytes of n groups.  Groups past what the card holds run in
    further launches, never one group's blocks in waves; a group the card
    cannot hold at all raises, naming the numbers."""
    if size > resident:
        raise ValueError(
            f"{what}: the global-memory kernel needs the {size} blocks of a "
            f"group resident at once, the card holds {resident} blocks of "
            f"this launch shape at once")
    per = min(n_groups, resident // size)
    return LaunchPlan("global", size, per, -(-n_groups // per),
                      workspace(per))


def plan_groups(fits, n_groups: int, ny: int, n_sm: int, active, resident,
                workspace: Callable[[int, int], int], what: str, size=None,
                force_global: bool = False, resident_fits=(),
                resident_active=None,
                resident_workspace: Callable[[int, int, int], int] = None
                ) -> LaunchPlan:
    """How a CFD kernel runs ``n_groups`` groups of ``ny`` rows on a card
    of ``n_sm`` SMs.  ``fits``: the cluster sizes whose band fits one
    block's shared memory (:func:`fitting_clusters`); where there is one
    (and not ``force_global``) the cluster kernel runs, at ``size`` or
    :func:`choose_cluster`'s choice fed ``active(c)``, the clusters of
    ``c`` blocks the card holds at once.  Else, where ``resident_fits``
    holds a group size (:func:`resident_groups`), the resident kernel,
    planned by :func:`resident_plan` from ``resident_active(C, G)`` and
    ``resident_workspace(G, C, n)``.  Else (or with ``force_global``) the
    global-memory kernel, at ``size`` or :func:`global_group`'s G,
    planned by :func:`global_plan` from ``resident(G)``, the blocks the
    card holds at once at that launch shape, and ``workspace(G, n)``, the
    bytes of n groups.  A size the kernel cannot take raises."""
    if fits and not force_global:
        if size is None:
            size = choose_cluster(fits, n_groups, n_sm, {
                c: active(c) for c in (16, 8, 4, 2)
                if c in fits and n_groups * c <= n_sm})
        elif size not in fits:
            raise ValueError(f"{what}: a cluster of {size} blocks cannot "
                             f"hold it in shared memory; sizes that fit: "
                             f"{fits}")
        # one launch: clusters the card cannot hold at once run in waves,
        # as no cluster waits for another
        return LaunchPlan("cluster", size, n_groups, 1, 0, size)
    if resident_fits and not force_global:
        return resident_plan(resident_fits, n_groups, resident_active,
                             resident_workspace, what, size)
    if size is None:
        size = global_group(ny, n_groups, n_sm)
    elif not 1 <= size <= min(GROUP_MAX, ny):
        raise ValueError(f"{what}: a group of {size} blocks; the global-"
                         f"memory kernel splits {ny} rows over 1 to "
                         f"{min(GROUP_MAX, ny)} blocks")
    return global_plan(n_groups, size, resident(size),
                       lambda n: workspace(size, n), what)


_RESIDENT: Dict[tuple, int] = {}


def resident_blocks(lib, query: str, dev, shape: tuple, args: tuple,
                    threads: int) -> int:
    """Blocks of a global-memory kernel the card holds at once at
    ``threads`` threads a block: its library's ``query(*args, threads,
    int*)`` export (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
    times the SM count, read once per card, launch shape and block size."""
    key = (query, shape, dev.index, args, threads)
    if key not in _RESIDENT:
        from repro_torch.kernels.build import check_launch
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = getattr(lib, query)(*args, threads, ctypes.byref(n))
        check_launch(lib, err, f"{query} occupancy query")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        _RESIDENT[key] = n.value * n_sm
    return _RESIDENT[key]
