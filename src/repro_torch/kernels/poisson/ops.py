"""Red-black SOR slab smoothers and the solves built on them.

Port of ``repro.kernels.poisson``.  Two smoothers of block-Jacobi rounds,
each on a CUDA tensor a hand-written kernel and on a CPU tensor its plain
twin:

* :func:`rb_sor_slabs_packed` (``kernel.rb_sor_slabs_packed``) on packed
  planes ``(..., ny, W)`` from ``cfd.poisson.pack_checkerboard``:
  ``csrc/poisson_sor.cu``, one cluster of blocks per (env, slab) and all
  rounds of a one-slab solve in one launch; twin
  :func:`rb_sor_slabs_packed_plain`, one round;
* :func:`rb_sor_slabs` (``kernel.rb_sor_slabs``) on the full grid ``(...,
  ny, nx)`` with a masked update: ``csrc/poisson_sor_full.cu``, the same
  cluster design on the grid split into packed planes as each block loads
  it; twin :func:`rb_sor_slabs_plain` (the reference's
  ``ref.rb_sor_slabs_ref``), one round.

The full-grid library also holds the full sweeps (:func:`full_sweeps`):
on a grid of odd width, where the reference's slab kernel has no
checkerboard parity and its ``solve(backend="pallas")`` runs its
full-grid sweep instead, the same kernels compute that sweep (``iters``
pairs on the whole grid, the BCs live, the last ``n_polish`` at omega 1)
on packed planes ``(nx + 1) // 2`` wide, each row's dead slot skipped;
their twin is :func:`full_sweeps_plain`, on the same odd layout
(:func:`pack_planes`), for the tests.

Each library holds three kernels (``csrc/sor_slabs.cuh``): the cluster
kernel on every slab a 16-block cluster holds in shared memory; past
that the resident kernel, a group of G = K C blocks per (env, slab) over
K clusters holding the slab's bands in shared memory, only the rows at
cluster edges through global memory, on every slab whose band fits one
block at such a G; and past that the global-memory kernel, a group of G
blocks per (env, slab) on planes kept in a workspace in global memory
(:func:`slab_kernel`; the reference's slab count, :func:`_pick_nslabs`,
stays: it sets the block-Jacobi numerics).  :func:`rb_sor_planes` and the drop-in
:func:`rb_sor` run ``ceil(iters / inner_iters)`` rounds and no polish, the
reference's semantics.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.cfd.poisson import (pack_checkerboard, packed_ghost_rows,
                                     packed_half_sweep, sor_coefficients,
                                     unpack_checkerboard)
from repro_torch.kernels import SMEM_PER_BLOCK, allocating, counted
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.cluster import (FLAG_STRIDE, LaunchPlan,
                                         mirror_floats, packed_width)

# float32 operations of one point of one SOR half-sweep, counted from the
# kernels' source (csrc/sor_packed.cuh)
FLOP_SOR_POINT = 10


def work(n: int, ny: int, nx: int, iters: int, inner_iters: int = 4):
    """(flops, bytes) of one solve of ``n`` (ny, nx) grids at ``iters``
    (``ceil(iters / inner_iters)`` rounds of ``inner_iters`` pairs of
    half-sweeps, each touching half the points): p and rhs read and p
    written once, in float32, whether as the grid or as its two packed
    planes."""
    rounds = -(-iters // inner_iters) if iters > 0 else 0
    return (n * rounds * inner_iters * ny * nx * FLOP_SOR_POINT,
            4 * n * ny * nx * 3)


def _pick_nslabs(nx: int) -> int:
    """The reference's slab count: ~512 full-grid columns a slab, even."""
    nslabs = max(1, nx // 512)
    while nx % nslabs or (nx // nslabs) % 2:
        nslabs -= 1
    return nslabs


def _check_slabs(w: int, nslabs: int) -> int:
    if nslabs <= 0 or w % nslabs:
        raise ValueError(f"packed width {w} does not split into {nslabs} "
                         f"slabs")
    return w // nslabs


def smem_bytes(ny: int, bxp: int, cluster: int) -> int:
    """Shared-memory bytes one block of the kernel claims when a ``(ny,
    bxp)`` slab spreads over ``cluster`` blocks: the largest band of red
    and black with a halo row above and below, of rhs_r and rhs_b, its
    four frozen ghost columns and the halo exchange's two mbarriers."""
    r = kcluster.rows_max(kcluster.band_starts(ny, cluster))
    return 4 * (4 + 2 * (r + 2) * bxp + 2 * r * bxp + 4 * r)


def _fitting_clusters(ny: int, bxp: int) -> list:
    return kcluster.fitting_clusters(
        ny, lambda c: smem_bytes(ny, bxp, c), SMEM_PER_BLOCK)


def _resident_groups(ny: int, bxp: int) -> list:
    return kcluster.resident_groups(
        ny, lambda g: smem_bytes(ny, bxp, g), SMEM_PER_BLOCK)


def slab_kernel(ny: int, bxp: int) -> str:
    """Which kernel serves a ``(ny, bxp)`` slab of packed planes: "cluster"
    where a cluster of at most 16 blocks holds it, one band per block in
    shared memory (every grid up to res 70 at the default aspect and the
    reference's slab count), "resident" where a group of G = K C <= 32
    blocks does (every grid from res 71 to 160 but 23: res 95, 97, 101,
    ...), "global" past that."""
    if _fitting_clusters(ny, bxp):
        return "cluster"
    return "resident" if _resident_groups(ny, bxp) else "global"


def check_planes(ny: int, w: int, nslabs: int) -> int:
    """The slab width of ``(ny, w)`` packed planes in ``nslabs`` slabs;
    ``ValueError`` unless the slabs split the width.  Every such slab has
    a kernel (:func:`slab_kernel`)."""
    return _check_slabs(w, nslabs)


def slab_floats(ny: int, bxp: int) -> int:
    """Floats of one (env, slab) in the global-memory kernel's workspace
    (csrc/sor_slabs.cuh slab_ws_floats): red and black (ny + 2) x bxp,
    rhs_r and rhs_b ny x bxp, four ghost columns of ny."""
    return 2 * (ny + 2) * bxp + 2 * ny * bxp + 4 * ny


def workspace_bytes(ny: int, bxp: int, group: int, n_groups: int) -> int:
    """The global-memory kernel's workspace for ``n_groups`` (env, slab)
    groups of ``group`` blocks: every group's planes, then each block's
    flag on a 128-byte line of its own."""
    return 4 * n_groups * (slab_floats(ny, bxp) + group * FLAG_STRIDE)


# the slots of one direction of a cluster edge of the resident kernel: red
# and black by parity, as tagged words (two slots each;
# csrc/resident.cuh kSorEdgeSlots)
EDGE_SLOTS = 8


def resident_workspace_bytes(ny: int, bxp: int, group: int, cluster: int,
                             n_groups: int) -> int:
    """The resident kernel's workspace for ``n_groups`` (env, slab) groups
    of ``group`` blocks in clusters of ``cluster``: each group's mirror
    slots (rows of ``bxp`` floats as tagged words), and no flags."""
    return 4 * n_groups * mirror_floats(group, cluster, EDGE_SLOTS, bxp)


def plan_launch(ny: int, w: int, nslabs: int, n_env: int, n_sm: int,
                active, resident, cluster=None, force_global: bool = False,
                resident_active=None) -> LaunchPlan:
    """How a slab kernel runs ``n_env`` envs of ``(ny, w)`` packed planes
    in ``nslabs`` slabs on a card of ``n_sm`` SMs: ``active(c)`` clusters
    of ``c`` blocks of the cluster kernel the card holds at once,
    ``resident_active(C, G)`` of the resident kernel at the launch shape of
    G blocks a group (by default ``active(C)``), ``resident(G)`` blocks of
    the global-memory kernel at that launch shape.  The kernel is
    :func:`slab_kernel`'s, or the global-memory one with ``force_global``;
    ``cluster`` fixes the blocks of a group (the cluster size, or G), by
    default :func:`choose_cluster`'s,
    :func:`repro_torch.kernels.cluster.resident_plan`'s or
    :func:`repro_torch.kernels.cluster.global_group`'s.  A size the kernel
    cannot take, or a group the card cannot hold at once, raises."""
    bxp = check_planes(ny, w, nslabs)
    return kcluster.plan_groups(
        _fitting_clusters(ny, bxp), n_env * nslabs, ny,
        n_sm, active, resident,
        lambda g, n: workspace_bytes(ny, bxp, g, n),
        f"SOR slab kernel on ({ny}, {bxp}) slabs", cluster, force_global,
        _resident_groups(ny, bxp),
        resident_active or (lambda c, g: active(c)),
        lambda g, c, n: resident_workspace_bytes(ny, bxp, g, c, n))


def choose_cluster(ny: int, bxp: int, n_groups: int, n_sm: int,
                   active) -> int:
    """The cluster size for ``n_groups`` (env, slab) clusters of ``(ny,
    bxp)`` slabs: :func:`repro_torch.kernels.cluster.choose_cluster` over
    the sizes whose band of this kernel's planes fits one block."""
    return kcluster.choose_cluster(_fitting_clusters(ny, bxp), n_groups,
                                   n_sm, active)


def rb_sor_slabs_packed_plain(red, black, rhs_r, rhs_b, *, dx: float,
                              dy: float, omega: float, nslabs: int,
                              inner_iters: int):
    """The kernel's plain twin: every slab smoothed with ghost columns
    frozen from the input planes (block-Jacobi), as the reference kernel."""
    ny, w = red.shape[-2:]
    bxp = _check_slabs(w, nslabs)
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    row_odd = (torch.arange(ny, device=red.device) % 2 == 1)[:, None]
    outs_r, outs_b = [], []
    for s in range(nslabs):
        lo, hi = s * bxp, (s + 1) * bxp
        r, b = red[..., lo:hi], black[..., lo:hi]
        fr, fb = rhs_r[..., lo:hi], rhs_b[..., lo:hi]
        r_lg = r[..., :1] if s == 0 else black[..., lo - 1:lo]
        r_rg = -r[..., -1:] if s == nslabs - 1 else black[..., hi:hi + 1]
        b_lg = b[..., :1] if s == 0 else red[..., lo - 1:lo]
        b_rg = -b[..., -1:] if s == nslabs - 1 else red[..., hi:hi + 1]
        for _ in range(inner_iters):
            r = packed_half_sweep(r, b, fr, r_lg, r_rg,
                                  *packed_ghost_rows(r, b), row_odd, omega,
                                  dx2, dy2, inv_diag)
            b = packed_half_sweep(b, r, fb, b_lg, b_rg,
                                  *packed_ghost_rows(b, r), ~row_odd, omega,
                                  dx2, dy2, inv_diag)
        outs_r.append(r)
        outs_b.append(b)
    return torch.cat(outs_r, dim=-1), torch.cat(outs_b, dim=-1)


# the kernels of csrc/sor_slabs.cuh, keyed as the functions below take
# ``full``: the packed slab smoother (False), the full-grid one (True) and
# the full-grid library's full sweeps of an odd width (SWEEPS); each the
# library, the cluster kernel's launch export and occupancy query, the
# global-memory kernel's, the resident kernel's
SWEEPS = "sweeps"
_LIBS = {False: ("poisson_sor", "rb_sor_slabs_packed_launch",
                 "rb_sor_packed_max_clusters",
                 "rb_sor_slabs_packed_global_launch",
                 "rb_sor_packed_global_blocks_per_sm",
                 "rb_sor_slabs_packed_resident_launch",
                 "rb_sor_packed_resident_max_clusters"),
         True: ("poisson_sor_full", "rb_sor_slabs_full_launch",
                "rb_sor_full_max_clusters", "rb_sor_slabs_full_global_launch",
                "rb_sor_full_global_blocks_per_sm",
                "rb_sor_slabs_full_resident_launch",
                "rb_sor_full_resident_max_clusters"),
         SWEEPS: ("poisson_sor_full", "rb_sor_full_sweeps_launch",
                  "rb_sor_full_sweeps_max_clusters",
                  "rb_sor_full_sweeps_global_launch",
                  "rb_sor_full_sweeps_global_blocks_per_sm",
                  "rb_sor_full_sweeps_resident_launch",
                  "rb_sor_full_sweeps_resident_max_clusters")}


def _load(full: bool = False):
    from repro_torch.kernels import build
    (name, launch, query, global_launch, global_query, resident_launch,
     resident_query) = _LIBS[full]
    lib = build.load(name)
    if getattr(lib, launch).argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the operand pointers (4 planes and 2 outputs, or p, rhs and the
        # output), block_sm, then sor_slabs.cuh launch_sor_slabs's
        n_ptr = 7 if full is False else 4
        getattr(lib, launch).argtypes = (
            [p] * n_ptr + [i] * 8 + [p] + [i] * 4 + [f] * 5 + [p])
        getattr(lib, launch).restype = ctypes.c_int
        getattr(lib, query).argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        getattr(lib, query).restype = ctypes.c_int
        # the operand pointers, block_sm and the workspace, then
        # launch_sor_slabs_global's
        getattr(lib, global_launch).argtypes = (
            [p] * (n_ptr + 1) + [i] * 11 + [f] * 5 + [p])
        getattr(lib, global_launch).restype = ctypes.c_int
        getattr(lib, global_query).argtypes = [i, ctypes.POINTER(i)]
        getattr(lib, global_query).restype = ctypes.c_int
        # the operand pointers, block_sm and the workspace, then
        # launch_sor_slabs_resident's
        getattr(lib, resident_launch).argtypes = (
            [p] * (n_ptr + 1) + [i] * 14 + [f] * 5 + [p])
        getattr(lib, resident_launch).restype = ctypes.c_int
        getattr(lib, resident_query).argtypes = [i, i, i,
                                                 ctypes.POINTER(i)]
        getattr(lib, resident_query).restype = ctypes.c_int
    return lib


def _launch_shape(ny: int, bxp: int, cluster: int,
                  resident: bool = False) -> tuple:
    """(band starts, rows of the largest band, threads, lanes a row) of
    ``cluster`` blocks a group (``resident``: the resident kernel's block,
    thread rows side by side over a band in shared memory)."""
    starts = kcluster.band_starts(ny, cluster)
    rows = kcluster.rows_max(starts)
    shape = kcluster.resident_shape if resident else kcluster.block_shape
    return (starts, rows, *shape(bxp, rows))


def active_clusters(dev, ny: int, bxp: int, size: int,
                    full: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``size`` blocks on ``(ny,
    bxp)`` slabs of packed planes (``full``: of the full-grid kernel, on
    slabs of ``2 * bxp`` grid columns; SWEEPS: of its full sweeps), read
    once per shape and card."""
    threads = _launch_shape(ny, bxp, size)[2]
    return kcluster.active_clusters(
        _load(full), _LIBS[full][2], dev, (ny, bxp), size, threads,
        smem_bytes(ny, bxp, size))


def resident_active_clusters(dev, ny: int, bxp: int, size: int, group: int,
                             full: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the resident kernel (``full``:
    the full-grid one) in clusters of ``size`` blocks at the launch shape
    of ``group`` blocks on ``(ny, bxp)`` slabs, read once per shape and
    card."""
    threads = _launch_shape(ny, bxp, group, resident=True)[2]
    return kcluster.active_clusters(
        _load(full), _LIBS[full][6], dev, (ny, bxp, group), size, threads,
        smem_bytes(ny, bxp, group))


def resident_blocks(dev, ny: int, bxp: int, group: int,
                    full: bool = False) -> int:
    """Blocks of the global-memory kernel (``full``: the full-grid one) the
    card holds at once at the launch shape of ``group`` blocks on ``(ny,
    bxp)`` slabs, read once per shape and card."""
    return kcluster.resident_blocks(
        _load(full), _LIBS[full][4], dev, (ny, bxp), (),
        _launch_shape(ny, bxp, group)[2])


def launch_plan(ny: int, w: int, nslabs: int, n_env: int, device,
                full: bool = False, cluster=None,
                force_global: bool = False) -> LaunchPlan:
    """:func:`plan_launch` fed the card of ``device``: its SM count, the
    cluster and resident kernels' cluster occupancy and the global-memory
    kernel's residency."""
    bxp = check_planes(ny, w, nslabs)
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return plan_launch(
        ny, w, nslabs, n_env, n_sm,
        lambda c: active_clusters(dev, ny, bxp, c, full),
        lambda g: resident_blocks(dev, ny, bxp, g, full), cluster,
        force_global,
        lambda c, g: resident_active_clusters(dev, ny, bxp, c, g, full))


def cluster_for(ny: int, w: int, nslabs: int, n_env: int, device,
                full: bool = False) -> int:
    """The blocks a group :func:`rb_sor_slabs_packed_cuda` (``full``:
    :func:`rb_sor_slabs_cuda`) launches with for ``n_env`` envs of ``(ny,
    w)`` packed planes in ``nslabs`` slabs on the card of ``device``: the
    cluster size, or G on slabs the resident or the global-memory kernel
    serves."""
    return launch_plan(ny, w, nslabs, n_env, device, full).size


_LAUNCH_CONFIGS = {}


def _launch_config(dev, ny: int, w: int, nslabs: int, n_env: int,
                   cluster, full: bool = False,
                   force_global: bool = False) -> tuple:
    """(plan, band starts as a C array, rows of the largest band, threads,
    lanes a row, shared-memory bytes) of a launch on ``(ny, w)`` packed
    planes, worked out once per kernel, card, shape, env count, requested
    size (None: the wrapper's choice) and kernel, so a solve's host work is
    the launch itself."""
    key = (full, dev.index, ny, w, nslabs, n_env, cluster, force_global)
    if key not in _LAUNCH_CONFIGS:
        bxp = check_planes(ny, w, nslabs)
        plan = launch_plan(ny, w, nslabs, n_env, dev, full, cluster,
                           force_global)
        starts, rows, threads, tx = _launch_shape(
            ny, bxp, plan.size, resident=plan.kernel == "resident")
        _LAUNCH_CONFIGS[key] = (
            plan, (ctypes.c_int * len(starts))(*starts), rows, threads, tx,
            smem_bytes(ny, bxp, plan.size) if plan.kernel != "global"
            else 0)
    return _LAUNCH_CONFIGS[key]


def _check_rounds(rounds: int, nslabs: int) -> None:
    if rounds < 1 or (rounds > 1 and nslabs != 1):
        raise ValueError(f"one launch runs 1 round, or several with one "
                         f"slab; got {rounds} rounds over {nslabs} slabs")


def _operands(ref, named) -> list:
    """The ``(name, tensor)`` operands of a launch as ``(n, ny, w)``
    contiguous float32 on ``ref``'s device, checked against ``ref``."""
    dev, ny, w = ref.device, *ref.shape[-2:]
    out = []
    for name, t in named:
        if t.shape != ref.shape or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"{name}: expected float32 {tuple(ref.shape)} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        out.append(t.reshape(-1, ny, w).contiguous())
    return out


def _launch(full: bool, operands, make_outs, *, ny: int, w: int, dx: float,
            dy: float, omega: float, nslabs: int, inner_iters: int,
            rounds: int, cluster, force_global: bool, what: str,
            n_sor=None):
    """Launch a slab kernel (``full``: as ``_LIBS`` keys it) on
    ``operands`` (``(n, ny, width)``, the planes of width ``w`` or the grid)
    into ``make_outs()``'s outputs, allocated beside the launch's record and
    workspace; the pairs from ``n_sor`` on (by default none) at omega 1.
    Returns (outputs, plan, the record of the SM each block ran on)."""
    from repro_torch.kernels.build import check_launch
    dev = operands[0].device
    n = operands[0].shape[0]
    plan, starts, rows, threads, tx, smem = _launch_config(
        dev, ny, w, nslabs, n, cluster, full, force_global)
    n_blocks = n * nslabs * plan.size
    out_bytes = 4 * (operands[0].numel() * (1 if full else 2) + n_blocks)
    with allocating(what, out_bytes + plan.workspace_bytes, dev):
        outs = make_outs()
        block_sms = torch.empty(n_blocks, dtype=torch.int32, device=dev)
        ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=dev) if plan.workspace_bytes else None)
    _, _, inv_diag = sor_coefficients(dx, dy)
    coeffs = (1.0 / dx ** 2, 1.0 / dy ** 2, inv_diag, omega, 1.0 - omega)
    ptrs = [t.data_ptr() for t in operands + outs] + [block_sms.data_ptr()]
    width = operands[0].shape[-1]
    n_sor = rounds * inner_iters if n_sor is None else n_sor
    lib = _load(full)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.kernel == "cluster":
            err = getattr(lib, _LIBS[full][1])(
                *ptrs, n, ny, width, nslabs, inner_iters, rounds, n_sor,
                plan.size, ctypes.cast(starts, ctypes.c_void_p), rows,
                threads, tx, smem, *coeffs, stream)
        elif plan.kernel == "resident":
            err = getattr(lib, _LIBS[full][5])(
                *ptrs, ws.data_ptr(), n, ny, width, nslabs, inner_iters,
                rounds, n_sor, plan.size, plan.cluster, plan.per_launch,
                rows, threads, tx, smem, *coeffs, stream)
        else:
            err = getattr(lib, _LIBS[full][3])(
                *ptrs, ws.data_ptr(), n, ny, width, nslabs, inner_iters,
                rounds, n_sor, plan.size, plan.per_launch, threads, tx,
                *coeffs, stream)
    check_launch(lib, err, f"{what} ({plan.kernel})")
    return outs, plan, block_sms


def _record(wrapper, plan: LaunchPlan, block_sms) -> None:
    """A slab wrapper's launch counters and its record of the last call."""
    wrapper.launches += plan.launches
    wrapper.launches_resident += plan.launches * (plan.kernel == "resident")
    wrapper.launches_global += plan.launches * (plan.kernel == "global")
    wrapper.last_kernel = plan.kernel
    wrapper.last_cluster = plan.size
    wrapper.last_plan = plan
    wrapper.last_block_sms = block_sms


def _reset_record(wrapper) -> None:
    wrapper.launches = 0
    wrapper.launches_resident = 0
    wrapper.launches_global = 0
    wrapper.last_kernel = None
    wrapper.last_cluster = None
    wrapper.last_plan = None
    wrapper.last_block_sms = None


def rb_sor_slabs_packed_cuda(red, black, rhs_r, rhs_b, *, dx: float,
                             dy: float, omega: float, nslabs: int,
                             inner_iters: int, rounds: int = 1,
                             cluster=None, force_global: bool = False):
    """One call of ``csrc/poisson_sor.cu``: ``rounds`` block-Jacobi rounds
    (more than one only with one slab).  The cluster kernel on slabs a
    cluster holds (one launch, one cluster of ``cluster`` blocks per (env,
    slab), by default :func:`launch_plan`'s choice), else the resident
    kernel where a group of G = K C blocks holds a slab's bands (a group of
    ``cluster`` blocks per (env, slab), G, in K clusters of C, by default
    its choice; one launch while the card holds every group's clusters at
    once), else the global-memory kernel (a group of ``cluster`` blocks per
    (env, slab), G, by default its choice; one launch while the card holds
    every group at once), which ``force_global`` also picks on any other
    slab.  Each call records its kernel (``.last_kernel``), its blocks a
    group (``.last_cluster``), its plan (``.last_plan``) and the SM each
    block ran on (``.last_block_sms``, int32, one per block, -1 where none
    ran); ``.launches`` counts every launch, ``.launches_resident`` and
    ``.launches_global`` those of the resident and the global-memory
    kernel."""
    dev = red.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_packed_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take the plain twin")
    ny, w = red.shape[-2:]
    _check_rounds(rounds, nslabs)
    planes = _operands(red, (("red", red), ("black", black), ("rhs_r", rhs_r),
                             ("rhs_b", rhs_b)))
    outs, plan, block_sms = _launch(
        False, planes, lambda: [torch.empty_like(planes[0]),
                                torch.empty_like(planes[1])],
        ny=ny, w=w, dx=dx, dy=dy, omega=omega, nslabs=nslabs,
        inner_iters=inner_iters, rounds=rounds, cluster=cluster,
        force_global=force_global, what="rb_sor_slabs_packed")
    _record(rb_sor_slabs_packed_cuda, plan, block_sms)
    return tuple(o.reshape(red.shape) for o in outs)


_reset_record(rb_sor_slabs_packed_cuda)


def rb_sor_slabs_packed(red, black, rhs_r, rhs_b, *, dx: float, dy: float,
                        omega: float, nslabs: int, inner_iters: int,
                        rounds: int = 1):
    """``rounds`` outer block-Jacobi rounds on packed planes, all slabs in
    parallel within a round (one round is the reference kernel's call).  On
    CUDA tensors the kernel: one launch for all rounds with one slab, one
    launch a round with several (a round's ghosts are the other slabs'
    columns); on CPU tensors the plain twin, round by round."""
    kw = dict(dx=float(dx), dy=float(dy), omega=float(omega), nslabs=nslabs,
              inner_iters=inner_iters)
    if red.device.type == "cuda" and nslabs == 1:
        return rb_sor_slabs_packed_cuda(red, black, rhs_r, rhs_b,
                                        rounds=rounds, **kw)
    step = (rb_sor_slabs_packed_cuda if red.device.type == "cuda"
            else rb_sor_slabs_packed_plain)
    for _ in range(rounds):
        red, black = step(red, black, rhs_r, rhs_b, **kw)
    return red, black


def _launches(ref, w: int, nslabs: int, rounds: int,
              full: bool = False) -> int:
    """The card's launches for a solve on ``ref``'s grids (packed width
    ``w``): one call with one slab, one a round with several, each call
    as many launches as its plan (one off the card, where the twin runs
    in their place); read only under a cost counter."""
    calls = 1 if nslabs == 1 else rounds
    if ref.device.type != "cuda":
        return calls
    ny = ref.shape[-2]
    n = ref.numel() // (ny * ref.shape[-1])
    plan = _launch_config(ref.device, ny, w, nslabs, n, None, full)[0]
    return calls * plan.launches


def rb_sor_planes(red, black, rhs_r, rhs_b, dx, dy, *, iters: int = 60,
                  omega: float = 1.7, nslabs: int = 0, inner_iters: int = 4):
    """``iters`` SOR iterations on packed planes as outer block-Jacobi
    rounds of ``inner_iters`` sweep pairs each (``ceil(iters /
    inner_iters)`` rounds, so the pair count rounds up); on the card one
    launch per solve where the planes take one slab.  Under a cost counter
    one call of ``rb_sor_slabs_packed`` with :func:`work`."""
    w = red.shape[-1]
    if nslabs == 0:
        nslabs = _pick_nslabs(2 * w)
    outer = -(-iters // inner_iters) if iters > 0 else 0
    if outer == 0:
        return red, black
    ny = red.shape[-2]
    with counted("rb_sor_slabs_packed", lambda: work(
            red.numel() // (ny * w), ny, 2 * w, iters, inner_iters),
            launches=lambda: _launches(red, w, nslabs, outer)):
        return rb_sor_slabs_packed(red, black, rhs_r, rhs_b, dx=dx, dy=dy,
                                   omega=omega, nslabs=nslabs,
                                   inner_iters=inner_iters, rounds=outer)


# ---------------------------------------------------------------------------
# full-grid slab smoother (rb_sor(packed=False))
# ---------------------------------------------------------------------------

def _check_full_slabs(nx: int, nslabs: int) -> int:
    if nslabs <= 0 or nx % nslabs or (nx // nslabs) % 2:
        raise ValueError(f"grid width {nx} does not split into {nslabs} "
                         f"slabs of even width")
    return nx // nslabs


def full_smem_bytes(ny: int, bx: int, cluster: int) -> int:
    """Shared-memory bytes one block of the full-grid kernel claims when a
    ``(ny, bx)`` slab spreads over ``cluster`` blocks: its band split into
    packed planes, so the packed kernel's bytes for a ``(ny, bx // 2)``
    slab (:func:`smem_bytes`)."""
    return smem_bytes(ny, bx // 2, cluster)


def check_grid(ny: int, nx: int, nslabs: int) -> int:
    """The slab width of a ``(ny, nx)`` grid in ``nslabs`` slabs;
    ``ValueError`` unless the slabs are of even width.  The full-grid
    kernel's shared memory per block is the packed kernel's on the split
    slab, so :func:`slab_kernel` of ``(ny, bx // 2)`` routes it: the
    cluster kernel up to res 70 at the default aspect, past it the
    resident kernel where its group holds the slab, else the global-memory
    kernel."""
    return _check_full_slabs(nx, nslabs)


def rb_sor_slabs_plain(p, rhs, *, dx: float, dy: float, omega: float,
                       nslabs: int, inner_iters: int):
    """The full-grid kernel's plain twin, as the reference's
    ``rb_sor_slabs_ref``: each slab smoothed with its ghost columns frozen
    from the input (the neighbour's edge column; the launch-time inlet
    column and negated outlet column at the domain ends), masked red then
    black updates, Neumann wall rows read live."""
    ny, nx = p.shape[-2:]
    bx = _check_full_slabs(nx, nslabs)
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    jj = torch.arange(ny, device=p.device)[:, None]
    ii = torch.arange(bx, device=p.device)[None, :]
    red = (ii + jj) % 2 == 0
    outs = []
    for s in range(nslabs):
        lo, hi = s * bx, (s + 1) * bx
        pi, ri = p[..., lo:hi], rhs[..., lo:hi]
        left = pi[..., :1] if s == 0 else p[..., lo - 1:lo]
        right = -pi[..., -1:] if s == nslabs - 1 else p[..., hi:hi + 1]

        def sweep(pb, mask):
            pp = torch.cat([left, pb, right], dim=-1)
            pp = torch.cat([pp[..., :1, :], pp, pp[..., -1:, :]], dim=-2)
            nb = ((pp[..., 1:-1, :-2] + pp[..., 1:-1, 2:]) / dx2
                  + (pp[..., :-2, 1:-1] + pp[..., 2:, 1:-1]) / dy2)
            p_gs = (nb - ri) * inv_diag
            return torch.where(mask, (1 - omega) * pb + omega * p_gs, pb)

        for _ in range(inner_iters):
            pi = sweep(pi, red)
            pi = sweep(pi, ~red)
        outs.append(pi)
    return torch.cat(outs, dim=-1)


def rb_sor_slabs_cuda(p, rhs, *, dx: float, dy: float, omega: float,
                      nslabs: int, inner_iters: int, rounds: int = 1,
                      cluster=None, force_global: bool = False):
    """One call of ``csrc/poisson_sor_full.cu``: ``rounds`` block-Jacobi
    rounds (more than one only with one slab), the grid's packed planes
    served as :func:`rb_sor_slabs_packed_cuda` serves them (the cluster,
    the resident or the global-memory kernel, ``cluster`` blocks a (grid,
    slab), ``force_global``), and recorded alike."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    ny, nx = p.shape[-2:]
    check_grid(ny, nx, nslabs)
    _check_rounds(rounds, nslabs)
    pf, rf = _operands(p, (("p", p), ("rhs", rhs)))
    (out,), plan, block_sms = _launch(
        True, [pf, rf], lambda: [torch.empty_like(pf)], ny=ny, w=nx // 2,
        dx=dx, dy=dy, omega=omega, nslabs=nslabs, inner_iters=inner_iters,
        rounds=rounds, cluster=cluster, force_global=force_global,
        what="rb_sor_slabs")
    _record(rb_sor_slabs_cuda, plan, block_sms)
    return out.reshape(p.shape)


_reset_record(rb_sor_slabs_cuda)


def rb_sor_slabs(p, rhs, *, dx: float, dy: float, omega: float, nslabs: int,
                 inner_iters: int, rounds: int = 1):
    """``rounds`` outer block-Jacobi rounds on the full grid, all slabs in
    parallel within a round (one round is the reference kernel's call).  On
    CUDA tensors the kernel: one launch for all rounds with one slab, one
    launch a round with several; on CPU tensors the plain twin, round by
    round."""
    kw = dict(dx=float(dx), dy=float(dy), omega=float(omega), nslabs=nslabs,
              inner_iters=inner_iters)
    if p.device.type == "cuda" and nslabs == 1:
        return rb_sor_slabs_cuda(p, rhs, rounds=rounds, **kw)
    step = (rb_sor_slabs_cuda if p.device.type == "cuda"
            else rb_sor_slabs_plain)
    for _ in range(rounds):
        p = step(p, rhs, **kw)
    return p


def rb_sor(rhs, dx, dy, *, iters: int = 60, omega: float = 1.7, p0=None,
           nslabs: int = 0, inner_iters: int = 4, packed: bool = True):
    """Drop-in pressure solve on ``(..., ny, nx)`` built from the slab
    smoothers: ``ceil(iters / inner_iters)`` block-Jacobi rounds of
    ``inner_iters`` sweep pairs and no polish.  ``packed=True`` runs the
    packed smoother on the checkerboard planes, ``packed=False`` the
    full-grid masked one; on the card either takes one launch per solve
    where the grid is one slab.  Raises ``ValueError`` on an odd width.
    Under a cost counter one call of the kernel it runs, with
    :func:`work`."""
    nx = rhs.shape[-1]
    if nx % 2:
        raise ValueError(
            f"rb_sor requires an even grid width for checkerboard slab "
            f"parity, got nx={nx}; use cfd.poisson.solve")
    if nslabs == 0:
        nslabs = _pick_nslabs(nx)
    p = torch.zeros_like(rhs) if p0 is None else p0
    if packed:
        planes = rb_sor_planes(*pack_checkerboard(p), *pack_checkerboard(rhs),
                               dx, dy, iters=iters, omega=omega,
                               nslabs=nslabs, inner_iters=inner_iters)
        return unpack_checkerboard(*planes)
    outer = -(-iters // inner_iters) if iters > 0 else 0
    if outer == 0:
        return p
    ny = rhs.shape[-2]
    with counted("rb_sor_slabs", lambda: work(
            rhs.numel() // (ny * nx), ny, nx, iters, inner_iters),
            launches=lambda: _launches(rhs, nx // 2, nslabs, outer,
                                       full=True)):
        return rb_sor_slabs(p, rhs, dx=dx, dy=dy, omega=omega,
                            nslabs=nslabs, inner_iters=inner_iters,
                            rounds=outer)


# ---------------------------------------------------------------------------
# the full sweeps of an odd width (solve(backend="pallas") on odd nx)
# ---------------------------------------------------------------------------

def pack_planes(a):
    """(..., ny, nx) grid -> ((..., ny, W) red, black) planes of width
    ``W = packed_width(nx)``: ``pack_checkerboard`` on an even width; on
    an odd one each row's dead slot (grid column nx: red's on odd rows,
    black's on even ones) holds 0."""
    if a.shape[-1] % 2:
        a = torch.nn.functional.pad(a, (0, 1))
    return pack_checkerboard(a)


def unpack_planes(red, black, nx: int):
    """Inverse of :func:`pack_planes` for an ``nx``-wide grid: the dead
    slots dropped."""
    return unpack_checkerboard(red, black)[..., :nx]


def odd_half_sweep(active, other, rhs_a, shift, om, dx2, dy2, inv_diag):
    """One coloured half-sweep on the odd layout's planes (``(..., ny,
    W)``, :func:`pack_planes`) with the domain BCs read live: the kernels'
    odd row rule (``csrc/sor_packed.cuh``).  ``shift`` (``(ny, 1)`` bool):
    the active colour's rows whose horizontal neighbours sit at packed
    columns (k, k+1); their last slot is dead and keeps its value.  The
    other rows' last point meets the Dirichlet outlet (-self) in place of
    the other plane's dead slot; their first point the Neumann inlet
    (self).  Walls Neumann.  The update's association is
    ``packed_half_sweep``'s."""
    last = torch.arange(active.shape[-1], device=active.device) == \
        active.shape[-1] - 1
    o_west = torch.cat([active[..., :, :1], other[..., :, :-1]], dim=-1)
    o_east = torch.cat([other[..., :, 1:], other[..., :, -1:]], dim=-1)
    east = torch.where(last, -active, other)
    horiz = torch.where(shift, other + o_east, o_west + east)
    north = torch.cat([active[..., :1, :], other[..., :-1, :]], dim=-2)
    south = torch.cat([other[..., 1:, :], active[..., -1:, :]], dim=-2)
    nb = horiz / dx2 + (north + south) / dy2
    p_gs = (nb - rhs_a) * inv_diag
    return torch.where(shift & last, active, (1 - om) * active + om * p_gs)


def odd_sweep_pair(red, black, rhs_r, rhs_b, om, *, dx: float, dy: float):
    """One red+black pair of :func:`odd_half_sweep` (red's shift rows are
    the odd rows, black's the even ones)."""
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    row_odd = (torch.arange(red.shape[-2], device=red.device) % 2
               == 1)[:, None]
    red = odd_half_sweep(red, black, rhs_r, row_odd, om, dx2, dy2, inv_diag)
    black = odd_half_sweep(black, red, rhs_b, ~row_odd, om, dx2, dy2,
                           inv_diag)
    return red, black


def full_sweeps_plain(p, rhs, *, dx: float, dy: float, omega: float,
                      iters: int, n_sor: int):
    """The full sweeps' plain twin on an odd width: ``iters`` pairs of
    :func:`odd_sweep_pair` on the odd layout's planes, the first ``n_sor``
    at ``omega``, the rest at 1; the reference's full-grid sweep
    (``cfd/poisson._full_sweeps``) on the kernels' layout."""
    nx = p.shape[-1]
    red, black = pack_planes(p)
    rhs_r, rhs_b = pack_planes(rhs)
    for i in range(iters):
        red, black = odd_sweep_pair(red, black, rhs_r, rhs_b,
                                    omega if i < n_sor else 1.0, dx=dx,
                                    dy=dy)
    return unpack_planes(red, black, nx)


def _check_odd(nx: int) -> None:
    if nx % 2 == 0:
        raise ValueError(f"the full sweeps serve odd grid widths, got "
                         f"nx={nx}; an even width takes the slab kernels")


def full_sweeps_cuda(p, rhs, *, dx: float, dy: float, omega: float,
                     iters: int, n_sor: int):
    """One launch of the full sweeps of ``csrc/poisson_sor_full.cu`` on
    ``(..., ny, nx)`` grids of odd width from the warm start ``p``:
    ``iters`` red+black pairs on the whole grid, the first ``n_sor`` at
    ``omega``, the rest at 1, on packed planes of :func:`packed_width`
    split from the grid as each block loads it.  The kernel and its
    blocks a grid are :func:`launch_plan`'s for a ``(ny,
    packed_width(nx))`` slab (the cluster, the resident or the
    global-memory kernel), recorded as :func:`rb_sor_slabs_cuda` records
    its launches."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"full_sweeps_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    ny, nx = p.shape[-2:]
    _check_odd(nx)
    pf, rf = _operands(p, (("p", p), ("rhs", rhs)))
    (out,), plan, block_sms = _launch(
        SWEEPS, [pf, rf], lambda: [torch.empty_like(pf)], ny=ny,
        w=packed_width(nx), dx=dx, dy=dy, omega=omega, nslabs=1,
        inner_iters=iters, rounds=1, cluster=None, force_global=False,
        what="full_sweeps", n_sor=n_sor)
    _record(full_sweeps_cuda, plan, block_sms)
    return out.reshape(p.shape)


_reset_record(full_sweeps_cuda)


def full_sweeps(rhs, p, dx, dy, *, iters: int, n_sor: int, omega: float):
    """The reference's full-grid SOR of an odd width (``iters`` pairs, the
    first ``n_sor`` at ``omega``): on CUDA tensors one launch of
    :func:`full_sweeps_cuda`, on CPU tensors :func:`full_sweeps_plain`.
    Under a cost counter one call of ``rb_sor_full_sweeps`` with
    :func:`work` (``iters`` pairs over every point)."""
    ny, nx = rhs.shape[-2:]
    _check_odd(nx)
    if iters <= 0:
        return p
    kw = dict(dx=float(dx), dy=float(dy), omega=float(omega), iters=iters,
              n_sor=n_sor)
    n = rhs.numel() // (ny * nx)

    def launches():
        if rhs.device.type != "cuda":
            return 1
        return _launch_config(rhs.device, ny, packed_width(nx), 1, n, None,
                              SWEEPS)[0].launches

    with counted("rb_sor_full_sweeps", lambda: work(n, ny, nx, iters, 1),
                 launches=launches):
        if rhs.device.type == "cuda":
            return full_sweeps_cuda(p, rhs, **kw)
        return full_sweeps_plain(p, rhs, **kw)
