"""Fused actuation-interval path: ``backend="fused"`` for the env hot loop.

Port of ``repro.kernels.actuation.ops``.  One actuation interval
(``steps_per_action`` dt's) runs with the velocity fields and both packed
pressure parity planes carried across every dt:

- on a CUDA tensor, one launch of a hand-written kernel of
  ``csrc/fused_interval.cu`` for the whole env batch, the dt loop inside
  the kernel (:func:`fused_interval_cuda`): the cluster kernel (one
  thread-block cluster per env, its fields in the cluster's shared memory)
  on every grid a cluster holds, the resident kernel (a group of G = K C
  blocks per env over K clusters, its fields in their shared memory, only
  the rows at cluster edges through global memory) where the bands fit
  one block only past one cluster, the global-memory kernel (a group of G
  blocks per env, its fields in a workspace in global memory) on every
  other grid; each in a scalar instantiation for a scalar amplitude and a
  per-body one (``max_bodies()`` bodies, each env reading its own geometry
  from a bank) for a per-body vector;
- on a CPU tensor, its plain PyTorch twin (:func:`fused_interval_plain`),
  which chains the solver's own ``_momentum`` -> packed SOR projection
  -> velocity correction, so the twin cannot drift from the solver.

Tier selection (:func:`select_tier`): a CPU state on a grid of odd width
(no checkerboard parity) falls back to the reference loop, warning once
per grid shape in the reference's words and counted in
``kernels.FALLBACKS``.  A CUDA state on a grid of odd width runs the
kernels, their packed planes ``(nx + 1) // 2`` wide with a dead slot a
row: every phase of a dt is then the reference loop's, the SOR its
full-grid sweep point for point.  Which kernel serves a grid
(:func:`check_kernel_grid`) follows the shared memory a block holds, the
analogue of the reference's VMEM budget: the cluster kernel where a
16-block cluster holds one env's bands, the resident kernel where a group
of up to 32 blocks does (res 39 to 52 at the default aspect), the
global-memory kernel past it.
"""
from __future__ import annotations

import ctypes
import warnings

import torch

from repro_torch._warn import warn_once_cache
from repro_torch.cfd import poisson, solver
from repro_torch.cfd.grid import GridConfig, geometry_names, max_bodies
from repro_torch.kernels import (SMEM_PER_BLOCK, allocating, counted,
                                 fell_back)
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.cluster import (CLUSTER_SIZES, FLAG_STRIDE,
                                         LaunchPlan, band_starts,
                                         block_shape, mirror_floats,
                                         packed_width, resident_shape,
                                         rows_max)

# the body count of the kernel's per-body instantiation
# (csrc/fused_interval.cu kBodies): the widest registered geometry
N_BODIES = max_bodies()

_FALLBACK_WARNED = warn_once_cache()

# float32 operations per point, counted from the kernel's source
FLOP_MOMENTUM_POINT = 51       # predictor + penalization + force, per face
FLOP_RHS_POINT = 6             # divergence / dt
FLOP_CORRECT_POINT = 4         # projection correction, per face
# the per-body instantiation, per face and body: the target's multiply-add
# and the force split's
FLOP_BODY_POINT = 4


def work(cfg: GridConfig, n_env: int, n_steps: int, n_bodies: int = 0,
         n_geoms: int = 1):
    """(float32 operations, bytes) of one fused interval: every input read
    once (the fields, the geometry of each of ``n_geoms`` geometries the
    batch uses, the per-env scalars) and every output written once.  The
    per-body instantiation (``n_bodies``) reads the per-body planes in
    place of the summed rotary target and does FLOP_BODY_POINT more
    operations per face and body."""
    from repro_torch.kernels.poisson.ops import FLOP_SOR_POINT
    ny, nx = cfg.ny, cfg.nx
    nu, nv, npts = ny * (nx + 1), (ny + 1) * nx, ny * nx
    flops = n_env * n_steps * (
        cfg.poisson_iters * npts * FLOP_SOR_POINT
        + (nu + nv) * (FLOP_MOMENTUM_POINT + FLOP_BODY_POINT * n_bodies)
        + npts * FLOP_RHS_POINT + (nu + nv) * FLOP_CORRECT_POINT)
    if not n_bodies:
        return flops, 4 * (2 * n_env * (nu + nv + npts) + 6 * nu + 6 * nv
                           + ny + 3 * n_env + 2 * n_env * n_steps)
    planes = 5 + 2 * n_bodies     # chi, 2 jet, jmask, rmask, rotb, own
    return flops, 4 * (2 * n_env * (nu + nv + npts)
                       + n_geoms * (planes * (nu + nv) + ny)
                       + n_env * (n_bodies + 3)
                       + 2 * n_env * n_steps * n_bodies)


def call_work(cfg: GridConfig, state, jet_vel, n_steps: int, geom_id=None):
    """:func:`work` of a call of :func:`fused_interval` on ``state``: the
    per-body instantiation's geometries are the distinct ``geom_id`` of
    the batch (the bank's size on meta tensors, which hold no ids)."""
    u = state.u
    n_env = u.shape[0] if u.dim() == 3 else 1
    if not solver.is_per_body(jet_vel, u):
        return work(cfg, n_env, n_steps)
    if geom_id is None:
        n_geoms = 1
    else:
        gid = torch.as_tensor(geom_id)
        n_geoms = (len(geometry_names()) if gid.device.type == "meta"
                   else int(gid.unique().numel()))
    return work(cfg, n_env, n_steps, N_BODIES, n_geoms)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def scratch_floats(n_bodies: int = 0) -> int:
    """Float slots beside the fields (csrc/fused_interval.cu): two
    mbarriers (4 slots), the block's partial sums (3 in 4 slots; 2 NB + 1,
    per-body fx and fy and the outflux, rounded up to 4) and the block
    reduction's slots (block_sum3's 128; block_sum's 33 per partial)."""
    if not n_bodies:
        return 4 + 4 + 128
    k = 2 * n_bodies + 1
    return 4 + _round4(k) + _round4(33 * k)


def smem_bytes(ny: int, nx: int, cluster: int, n_bodies: int = 0) -> int:
    """Dynamic shared-memory bytes of one block when an env of an (ny, nx)
    grid spreads over ``cluster`` blocks: the block's band (the largest of
    the partition) of u, v, u_pen, v_pen and the four packed planes, with
    their halo rows, the halo exchange's mbarriers and the reduction
    slots; ``n_bodies`` is the instantiation's body count (0: scalar).
    The packed planes are :func:`packed_width` wide."""
    r = rows_max(band_starts(ny, cluster))
    w = packed_width(nx)
    floats = ((r + 2) * (nx + 1)      # u, halo rows above and below
              + (r + 3) * nx          # v, halo above, below and the wall
              + r * nx                # u_pen (its outlet column implied)
              + (r + 1) * nx          # v_pen, halo below / wall row
              + 2 * (r + 2) * w       # red, black
              + 2 * r * w             # rhs_r, rhs_b
              + scratch_floats(n_bodies))
    return 4 * floats


def _fitting_clusters(ny: int, nx: int, smem_per_block: int,
                      n_bodies: int = 0) -> list:
    return kcluster.fitting_clusters(
        ny, lambda c: smem_bytes(ny, nx, c, n_bodies), smem_per_block)


def _resident_groups(ny: int, nx: int, smem_per_block: int,
                     n_bodies: int = 0) -> list:
    return kcluster.resident_groups(
        ny, lambda g: smem_bytes(ny, nx, g, n_bodies), smem_per_block)


def choose_cluster(ny: int, nx: int, n_env: int, n_sm: int, active,
                   smem_per_block: int, n_bodies: int = 0) -> int:
    """The cluster size for ``n_env`` envs on an (ny, nx) grid:
    :func:`repro_torch.kernels.cluster.choose_cluster` over the sizes
    whose band of this kernel's fields fits one block."""
    fits = _fitting_clusters(ny, nx, smem_per_block, n_bodies)
    if not fits:
        raise ValueError(f"no cluster of up to {CLUSTER_SIZES[-1]} blocks "
                         f"holds grid (ny={ny}, nx={nx})")
    return kcluster.choose_cluster(fits, n_env, n_sm, active)


def part_slots(n_bodies: int = 0) -> int:
    """Float slots of one block's partial sums (csrc/fused_interval.cu
    kPartSlots): fx, fy and the outflux in 4, or 2 NB + 1 rounded up to
    4."""
    return 4 if not n_bodies else _round4(2 * n_bodies + 1)


def env_floats(ny: int, nx: int) -> int:
    """Floats of one env's fields in the global-memory kernel's workspace
    (csrc/fused_interval.cu ws_floats): the env as one band of all ny rows,
    u (ny + 2) x (nx + 1), v (ny + 3) x nx, u_pen ny x nx, v_pen (ny + 1) x
    nx, red and black (ny + 2) x w, rhs_r and rhs_b ny x w, w the
    :func:`packed_width`."""
    w = packed_width(nx)
    return ((ny + 2) * (nx + 1) + (ny + 3) * nx + ny * nx + (ny + 1) * nx
            + 2 * (ny + 2) * w + 2 * ny * w)


def workspace_bytes(ny: int, nx: int, group: int, n_env: int,
                    n_bodies: int = 0) -> int:
    """The global-memory kernel's workspace for ``n_env`` envs of ``group``
    blocks each: every env's fields, then each block's partial sums, then
    each block's flag on a 128-byte line of its own."""
    return 4 * n_env * (env_floats(ny, nx) + group * part_slots(n_bodies)
                        + group * FLAG_STRIDE)


# the slots of one direction of a cluster edge of the resident kernel: red
# and black by parity as tagged words (two slots each), u, v and v_pen
# (csrc/resident.cuh kFusedEdgeSlots)
EDGE_SLOTS = 8 + 3


def resident_workspace_bytes(ny: int, nx: int, group: int, cluster: int,
                             n_env: int, n_bodies: int = 0) -> int:
    """The resident kernel's workspace for ``n_env`` envs of ``group``
    blocks in clusters of ``cluster``: each block's partial sums, then
    each block's flag line, then each env's mirror slots (rows of up to
    nx + 1 floats)."""
    return 4 * n_env * (group * part_slots(n_bodies) + group * FLAG_STRIDE
                        + mirror_floats(group, cluster, EDGE_SLOTS, nx + 1))


def check_kernel_grid(cfg: GridConfig, n_bodies: int = 0) -> str:
    """Which CUDA kernel serves the grid for the instantiation of
    ``n_bodies`` (0: scalar): "cluster" where one env's fields, cut into
    at most 16 bands, fit the shared memory of one block each (res <= 38
    at the default aspect, either instantiation), "resident" where they
    do cut into a group of G = K C <= 32 bands (res 39 to 52), "global" on
    every other grid, whatever the width's parity (an odd one's planes are
    :func:`packed_width` wide)."""
    ny, nx = cfg.ny, cfg.nx
    if _fitting_clusters(ny, nx, SMEM_PER_BLOCK, n_bodies):
        return "cluster"
    if _resident_groups(ny, nx, SMEM_PER_BLOCK, n_bodies):
        return "resident"
    return "global"


def plan_launch(cfg: GridConfig, n_env: int, n_sm: int, active, resident,
                n_bodies: int = 0, cluster=None, force_global: bool = False,
                resident_active=None) -> LaunchPlan:
    """How :func:`fused_interval_cuda` runs ``n_env`` envs on a card of
    ``n_sm`` SMs: ``active(c)`` is how many clusters of ``c`` blocks of the
    cluster kernel the card holds at once, ``resident_active(C, G)`` how
    many of the resident kernel at the launch shape of G blocks an env
    (by default ``active(C)``), ``resident(G)`` how many blocks of the
    global-memory kernel at that launch shape.  The kernel is
    :func:`check_kernel_grid`'s, or the global-memory one with
    ``force_global``; ``cluster`` fixes the blocks of an env (the cluster
    size, or G), by default :func:`choose_cluster`'s,
    :func:`repro_torch.kernels.cluster.resident_plan`'s or
    :func:`repro_torch.kernels.cluster.global_group`'s choice.  A size the
    kernel cannot take, or a group the card cannot hold at once, raises."""
    ny, nx = cfg.ny, cfg.nx
    check_kernel_grid(cfg, n_bodies)
    return kcluster.plan_groups(
        _fitting_clusters(ny, nx, SMEM_PER_BLOCK, n_bodies), n_env, ny, n_sm,
        active, resident, lambda g, n: workspace_bytes(ny, nx, g, n, n_bodies),
        f"fused_interval on grid (ny={ny}, nx={nx})", cluster, force_global,
        _resident_groups(ny, nx, SMEM_PER_BLOCK, n_bodies),
        resident_active or (lambda c, g: active(c)),
        lambda g, c, n: resident_workspace_bytes(ny, nx, g, c, n, n_bodies))


def select_tier(cfg: GridConfig, device, n_bodies: int = 0) -> str:
    """Which realization serves ``backend="fused"`` for tensors on ``device``.

    "cuda"       CUDA tensors: a hand-written kernel (its instantiation for
                 ``n_bodies``, 0: scalar; the cluster, the resident or the
                 global-memory kernel, :func:`check_kernel_grid`), on a
                 grid of either width parity
    "plain"      CPU tensors: its plain PyTorch twin
    "reference"  CPU tensors on a grid of odd width (warns once per shape,
                 in the reference's words)
    """
    if torch.device(device).type == "cuda":
        check_kernel_grid(cfg, n_bodies)
        return "cuda"
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        if ("odd_nx", ny, nx) not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(("odd_nx", ny, nx))
            warnings.warn(
                f"backend='fused' needs an even grid width for packed "
                f"checkerboard parity; grid (ny={ny}, nx={nx}) falls back "
                f"to the reference scan (this warning fires once per shape)",
                RuntimeWarning, stacklevel=3)
        return "reference"
    return "plain"


# ---------------------------------------------------------------------------
# the plain twin
# ---------------------------------------------------------------------------

def packed_projection_planes(cfg: GridConfig, red, black, rhs_r, rhs_b):
    """The pressure solve of one dt on packed planes: ``poisson_iters``
    pairs, the last ``n_polish`` unrelaxed."""
    iters = cfg.poisson_iters
    n_sor = iters - poisson.n_polish(iters)
    omega = float(cfg.poisson_omega)
    row_odd = (torch.arange(cfg.ny, device=red.device) % 2 == 1)[:, None]
    for i in range(iters):
        red, black = poisson.packed_sweep_pair(
            red, black, rhs_r, rhs_b, omega if i < n_sor else 1.0,
            dx=cfg.dx, dy=cfg.dy, row_odd=row_odd)
    return red, black


def fused_dt(cfg: GridConfig, ga: solver.GeomArrays, u, v, red, black,
             jet_vel, re, act_mode):
    """One dt with the pressure held packed.  Returns
    ``(u, v, red, black, cd, cl)``."""
    u_bc, v_bc, fx, fy = solver._momentum(cfg, ga, u, v, jet_vel, re,
                                          act_mode)
    rhs = solver.divergence(u_bc, v_bc, cfg) / cfg.dt
    rhs_r, rhs_b = poisson.pack_checkerboard(rhs)
    red, black = packed_projection_planes(cfg, red, black, rhs_r, rhs_b)
    p = poisson.unpack_checkerboard(red, black)
    u_new, v_new = solver._correct(cfg, ga, u_bc, v_bc, p)
    cd, cl = solver.force_coefficients(cfg, fx, fy)
    return u_new, v_new, red, black, cd, cl


def fused_interval_plain(cfg: GridConfig, geom_arrays, state, jet_vel,
                         n_steps: int, *, re=None, act_mode=None,
                         geom_id=None):
    """The kernel's plain PyTorch twin: ``fused_dt`` looped ``n_steps``
    times, the planes packed once before and unpacked once after.  A
    per-body ``jet_vel`` takes ``solver._momentum``'s per-body branch and
    gives ``(..., n_steps, B)`` coefficients; ``geom_id`` picks each env's
    geometry from the bank ``geom_arrays``."""
    ga = solver.GeomArrays(*geom_arrays)
    if geom_id is not None:
        ga = solver.gather_geometry(ga, geom_id)
    dim = -2 if solver.is_per_body(jet_vel, state.u) else -1
    re = cfg.re if re is None else re
    act_mode = 0.0 if act_mode is None else act_mode
    u, v = state.u, state.v
    red, black = poisson.pack_checkerboard(state.p)
    cds, cls = [], []
    for _ in range(n_steps):
        u, v, red, black, cd, cl = fused_dt(cfg, ga, u, v, red, black,
                                            jet_vel, re, act_mode)
        cds.append(cd)
        cls.append(cl)
    flow = solver.FlowState(u, v, poisson.unpack_checkerboard(red, black))
    return flow, solver.StepOutputs(cd=torch.stack(cds, dim=dim),
                                    cl=torch.stack(cls, dim=dim))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _consts(cfg: GridConfig):
    """The kernel's float constants (csrc/fused_interval.cu ``Consts``),
    each computed in float64, the reciprocals included, and rounded to
    float32."""
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    _, _, inv_diag = poisson.sor_coefficients(dx, dy)
    b, om = cfg.upwind_blend, float(cfg.poisson_omega)
    vals = (dt, dx, dy, 1 / dx, 1 / dy, 1 / dx ** 2, 1 / dy ** 2,
            1 / (2 * dx), 1 / (2 * dy), 1 / dt, b, 1 - b,
            dt / cfg.penal_eta, inv_diag, om, 1 - om, cfg.ny * dy,
            0.5 * cfg.u_mean ** 2)
    return (ctypes.c_float * len(vals))(*vals)


def _per_env_vector(x, n: int, device) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return t.expand(n).contiguous() if t.dim() == 0 else t.reshape(n).contiguous()


def _load():
    from repro_torch.kernels import build
    lib = build.load("fused_interval")
    if lib.fused_interval_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_interval_launch.argtypes = (
            [p] * 5 + [i] + [p] * 9 + [i] * 7 + [p] + [i] * 4 + [p, p])
        lib.fused_interval_launch.restype = ctypes.c_int
        for query in ("fused_interval_max_clusters",
                      "fused_interval_bodies_max_clusters"):
            getattr(lib, query).argtypes = [i, i, i, ctypes.POINTER(i)]
            getattr(lib, query).restype = ctypes.c_int
        lib.fused_interval_bodies.restype = ctypes.c_int
        if lib.fused_interval_bodies() != N_BODIES:
            raise RuntimeError(
                f"csrc/fused_interval.cu's per-body instantiation serves "
                f"{lib.fused_interval_bodies()} bodies, the geometries "
                f"need {N_BODIES}")
        lib.fused_interval_global_launch.argtypes = (
            [p] * 5 + [i] + [p] * 10 + [i] * 10 + [p, p])
        lib.fused_interval_global_launch.restype = ctypes.c_int
        lib.fused_interval_global_blocks_per_sm.argtypes = [
            i, i, ctypes.POINTER(i)]
        lib.fused_interval_global_blocks_per_sm.restype = ctypes.c_int
        lib.fused_interval_resident_launch.argtypes = (
            [p] * 5 + [i] + [p] * 10 + [i] * 15 + [p, p])
        lib.fused_interval_resident_launch.restype = ctypes.c_int
        for query in ("fused_interval_resident_max_clusters",
                      "fused_interval_bodies_resident_max_clusters"):
            getattr(lib, query).argtypes = [i, i, i, ctypes.POINTER(i)]
            getattr(lib, query).restype = ctypes.c_int
        lib.fused_interval_part_slots.argtypes = [i]
        lib.fused_interval_part_slots.restype = ctypes.c_int
        for nb in (0, N_BODIES):
            if lib.fused_interval_part_slots(nb) != part_slots(nb):
                raise RuntimeError(
                    f"csrc/fused_interval.cu keeps "
                    f"{lib.fused_interval_part_slots(nb)} partial-sum slots "
                    f"a block at {nb} bodies, the wrapper counts "
                    f"{part_slots(nb)}")
    return lib


def active_clusters(dev, cfg: GridConfig, size: int, n_bodies: int = 0
                    ) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the launch shape of ``size``
    blocks on ``cfg``'s grid (the instantiation for ``n_bodies``, 0:
    scalar), read once per shape and card."""
    threads, _ = block_shape(packed_width(cfg.nx),
                             rows_max(band_starts(cfg.ny, size)))
    query = ("fused_interval_bodies_max_clusters" if n_bodies
             else "fused_interval_max_clusters")
    return kcluster.active_clusters(
        _load(), query, dev, (cfg.ny, cfg.nx), size, threads,
        smem_bytes(cfg.ny, cfg.nx, size, n_bodies))


def resident_launch_shape(cfg: GridConfig, group: int) -> tuple:
    """``(rows of the largest band, threads, tx, predictor threads,
    predictor tx)`` of a block of the resident kernel with ``group`` blocks
    an env: its thread rows side by side over the band
    (:func:`repro_torch.kernels.cluster.resident_shape`), but in the
    predictor, whose force and outflux partial sums follow the layout, the
    global-memory kernel's (:func:`global_shape`), so that the two kernels
    add in one order; the block takes the larger thread count."""
    rows = rows_max(band_starts(cfg.ny, group))
    threads, tx = resident_shape(packed_width(cfg.nx), rows)
    pred_threads, pred_tx = global_shape(cfg, group)
    return rows, max(threads, pred_threads), tx, pred_threads, pred_tx


def resident_active_clusters(dev, cfg: GridConfig, size: int, group: int,
                             n_bodies: int = 0) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the resident kernel (the
    instantiation for ``n_bodies``) in clusters of ``size`` blocks at the
    launch shape of ``group`` blocks an env, read once per shape and
    card."""
    query = ("fused_interval_bodies_resident_max_clusters" if n_bodies
             else "fused_interval_resident_max_clusters")
    return kcluster.active_clusters(
        _load(), query, dev, (cfg.ny, cfg.nx, group), size,
        resident_launch_shape(cfg, group)[1],
        smem_bytes(cfg.ny, cfg.nx, group, n_bodies))


def global_shape(cfg: GridConfig, group: int) -> tuple:
    """``(threads, tx)`` of a block of the global-memory kernel with
    ``group`` blocks an env (:func:`repro_torch.kernels.cluster.
    block_shape` over its largest band)."""
    return block_shape(packed_width(cfg.nx),
                       rows_max(band_starts(cfg.ny, group)))


def resident_blocks(dev, cfg: GridConfig, group: int, n_bodies: int = 0
                    ) -> int:
    """Blocks of the global-memory kernel (the instantiation for
    ``n_bodies``) the card holds at once at the launch shape of ``group``
    blocks an env, read once per shape and card."""
    return kcluster.resident_blocks(
        _load(), "fused_interval_global_blocks_per_sm", dev,
        (cfg.ny, cfg.nx), (n_bodies,), global_shape(cfg, group)[0])


def launch_plan(cfg: GridConfig, n_env: int, device, n_bodies: int = 0,
                cluster=None, force_global: bool = False) -> LaunchPlan:
    """:func:`plan_launch` fed the card of ``device``: its SM count, the
    cluster and resident kernels' cluster occupancy and the global-memory
    kernel's residency."""
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return plan_launch(
        cfg, n_env, n_sm, lambda c: active_clusters(dev, cfg, c, n_bodies),
        lambda g: resident_blocks(dev, cfg, g, n_bodies), n_bodies, cluster,
        force_global, lambda c, g: resident_active_clusters(
            dev, cfg, c, g, n_bodies))


def cluster_for(cfg: GridConfig, n_env: int, device, n_bodies: int = 0
                ) -> int:
    """The blocks an env :func:`fused_interval_cuda` launches with for
    ``n_env`` envs on the card of ``device``: the cluster size, or G on a
    grid the resident or the global-memory kernel serves
    (:func:`launch_plan`)."""
    return launch_plan(cfg, n_env, device, n_bodies).size


def _shared_geometry(ga: solver.GeomArrays, geom_id, dev) -> list:
    """The scalar instantiation's 11 fields: the batch's one geometry (from
    the bank ``ga`` when ``geom_id`` is given, which must then pick one
    geometry for every env)."""
    fields = list(ga)[:11]
    if geom_id is not None:
        ids = torch.unique(torch.as_tensor(geom_id)).tolist()
        if len(ids) != 1:
            raise ValueError(
                f"the fused kernel's scalar instantiation serves one "
                f"geometry per launch, the batch mixes geometries {ids}; "
                f"pass a per-body (vector) amplitude")
        fields = [f[ids[0]] for f in fields]
    return [f.to(dev, torch.float32).contiguous() for f in fields]


def _bank(ga: solver.GeomArrays, geom_id, n: int, dev):
    """The per-body instantiation's geometry: the 15 fields as a bank of G
    geometries (G = 1 without ``geom_id``), the per-body fields padded with
    zero bodies to ``N_BODIES``; the int32 bank index of each env; and the
    geometry's own body count."""
    if ga.rotb_u is None:
        raise ValueError(
            "a per-body (vector) jet_vel needs the per-body geometry fields "
            "(rotb_*/own_*); build GeomArrays with "
            "geom_to_arrays(build_geometry(cfg, geometry))")
    fields = [f.to(dev, torch.float32) for f in ga]
    if geom_id is None:
        fields = [f[None] for f in fields]
        gid = torch.zeros(n, dtype=torch.int32, device=dev)
    else:
        gid = torch.as_tensor(geom_id, device=dev).to(torch.int32)
        gid = gid.expand(n) if gid.dim() == 0 else gid.reshape(n)
    nb = fields[11].shape[1]
    if nb > N_BODIES:
        raise ValueError(f"the fused kernel's per-body instantiation serves "
                         f"up to {N_BODIES} bodies, the geometry has {nb}")
    for k in range(11, 15):
        if nb < N_BODIES:
            fields[k] = torch.nn.functional.pad(
                fields[k], (0, 0, 0, 0, 0, N_BODIES - nb))
    return [f.contiguous() for f in fields], gid.contiguous(), nb


def _amplitudes(jet_vel, n: int, dev) -> torch.Tensor:
    """(n, N_BODIES) per-body amplitudes: a vector padded with zeros or cut
    to the kernel's body count (the slots past a geometry's bodies meet
    zero rotary targets, as in ``solver._momentum``)."""
    a = torch.as_tensor(jet_vel, dtype=torch.float32, device=dev)
    a = a.reshape(n, a.shape[-1])[:, :N_BODIES]
    if a.shape[1] < N_BODIES:
        a = torch.nn.functional.pad(a, (0, N_BODIES - a.shape[1]))
    return a.contiguous()


def fused_interval_cuda(cfg: GridConfig, geom_arrays, state, jet_vel,
                        n_steps: int, *, re=None, act_mode=None,
                        cluster=None, geom_id=None,
                        force_global: bool = False):
    """One call of a kernel of ``csrc/fused_interval.cu`` for the whole env
    batch: ``n_steps`` dt's, returns ``(FlowState, StepOutputs)`` with
    ``(N, n_steps)`` C_D / C_L (``(n_steps,)`` for an unbatched state).

    A per-body ``jet_vel`` (``(N, A)``, ``solver.is_per_body``) launches the
    per-body instantiation (``N_BODIES`` bodies) and gives ``(N, n_steps,
    B)`` coefficients for the geometry's B bodies; ``geom_id`` (``(N,)``)
    makes ``geom_arrays`` a bank from which each env reads its own
    geometry.  A scalar amplitude launches the scalar instantiation on one
    geometry.  A call the kernel cannot serve raises.

    The kernel is :func:`launch_plan`'s: the cluster kernel (one launch,
    each env on a cluster of ``cluster`` blocks, by default its choice; a
    size whose bands do not fit one block's shared memory raises) on the
    grids a cluster holds, the resident kernel (each env on a group of
    ``cluster`` blocks, G, in K clusters of C, by default its choice; one
    launch while the card holds every env's clusters at once, more past
    that) on the grids whose bands fit one block at such a G, else the
    global-memory kernel (each env on a group of ``cluster`` blocks, G, by
    default its choice; launched as the resident one), which
    ``force_global`` also picks on any other grid.  Each call records its
    kernel (``fused_interval_cuda.last_kernel``, "cluster", "resident" or
    "global"), its blocks an env (``last_cluster``), its plan
    (``last_plan``), the instantiation's body count (``last_n_bodies``, 0:
    scalar) and the SM each block ran on (``last_block_sms``, int32, one
    per block, -1 where none ran); ``launches`` counts every launch,
    ``launches_per_body`` those of the per-body instantiation,
    ``launches_resident`` and ``launches_global`` those of the resident
    and the global-memory kernel."""
    u, v, p = state
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"fused_interval_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take fused_interval_plain")
    per_body = solver.is_per_body(jet_vel, u)
    n_bodies = N_BODIES if per_body else 0
    check_kernel_grid(cfg, n_bodies)
    ny, nx = cfg.ny, cfg.nx
    batched = u.dim() == 3
    if not batched:
        u, v, p = u[None], v[None], p[None]
    n = u.shape[0]
    shapes = {"u": (u, (n, ny, nx + 1)), "v": (v, (n, ny + 1, nx)),
              "p": (p, (n, ny, nx))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"{name}: expected float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = launch_plan(cfg, n, dev, n_bodies, cluster, force_global)
    size = plan.size
    ga = solver.GeomArrays(*geom_arrays)
    if per_body:
        geom, gid, nb = _bank(ga, geom_id, n, dev)
        jet = _amplitudes(jet_vel, n, dev)
        out_shape = (n, n_steps, N_BODIES)
    else:
        geom, gid = _shared_geometry(ga, geom_id, dev), None
        jet = _per_env_vector(jet_vel, n, dev)
        out_shape = (n, n_steps)
    u, v, p = u.contiguous(), v.contiguous(), p.contiguous()
    re_t = _per_env_vector(cfg.re if re is None else re, n, dev)
    mode = _per_env_vector(0.0 if act_mode is None else act_mode, n, dev)
    out_bytes = 4 * (u.numel() + v.numel() + p.numel()
                     + 2 * n * n_steps * out_shape[-1] + n * size)
    with allocating("fused_interval", out_bytes + plan.workspace_bytes, dev):
        u_out, v_out, p_out = (torch.empty_like(u), torch.empty_like(v),
                               torch.empty_like(p))
        cd = torch.empty(out_shape, dtype=torch.float32, device=dev)
        cl = torch.empty_like(cd)
        block_sms = torch.empty(n * size, dtype=torch.int32, device=dev)
        ws = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                          device=dev) if plan.workspace_bytes else None)
    geom_ptrs = (ctypes.c_void_p * len(geom))(*[g.data_ptr() for g in geom])
    consts = _consts(cfg)
    operands = (u.data_ptr(), v.data_ptr(), p.data_ptr(),
                ctypes.cast(geom_ptrs, ctypes.c_void_p),
                None if gid is None else gid.data_ptr(), n_bodies,
                jet.data_ptr(), re_t.data_ptr(), mode.data_ptr(),
                u_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(),
                cd.data_ptr(), cl.data_ptr(), block_sms.data_ptr())
    iters, n_polish = cfg.poisson_iters, poisson.n_polish(cfg.poisson_iters)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.kernel == "cluster":
            starts = band_starts(ny, size)
            rows = rows_max(starts)
            threads, tx = block_shape(packed_width(nx), rows)
            starts_c = (ctypes.c_int * len(starts))(*starts)
            err = lib.fused_interval_launch(
                *operands, n, ny, nx, n_steps, iters, n_polish, size,
                ctypes.cast(starts_c, ctypes.c_void_p), rows, threads, tx,
                smem_bytes(ny, nx, size, n_bodies),
                ctypes.cast(consts, ctypes.c_void_p), stream)
        elif plan.kernel == "resident":
            rows, threads, tx, pred_threads, pred_tx = resident_launch_shape(
                cfg, size)
            err = lib.fused_interval_resident_launch(
                *operands, ws.data_ptr(), n, plan.per_launch, ny, nx,
                n_steps, iters, n_polish, size, plan.cluster, rows, threads,
                tx, pred_tx, pred_threads, smem_bytes(ny, nx, size, n_bodies),
                ctypes.cast(consts, ctypes.c_void_p), stream)
        else:
            threads, tx = global_shape(cfg, size)
            err = lib.fused_interval_global_launch(
                *operands, ws.data_ptr(), n, plan.per_launch, ny, nx,
                n_steps, iters, n_polish, size, threads, tx,
                ctypes.cast(consts, ctypes.c_void_p), stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, f"fused_interval ({plan.kernel})")
    fused_interval_cuda.launches += plan.launches
    fused_interval_cuda.launches_per_body += plan.launches * bool(per_body)
    fused_interval_cuda.launches_resident += plan.launches * (
        plan.kernel == "resident")
    fused_interval_cuda.launches_global += plan.launches * (
        plan.kernel == "global")
    fused_interval_cuda.last_kernel = plan.kernel
    fused_interval_cuda.last_cluster = size
    fused_interval_cuda.last_plan = plan
    fused_interval_cuda.last_n_bodies = n_bodies
    fused_interval_cuda.last_block_sms = block_sms
    if per_body:
        cd, cl = cd[..., :nb], cl[..., :nb]
    flow = solver.FlowState(u_out, v_out, p_out)
    if not batched:
        flow = solver.FlowState(*(a[0] for a in flow))
        cd, cl = cd[0], cl[0]
    return flow, solver.StepOutputs(cd=cd, cl=cl)


fused_interval_cuda.launches = 0
fused_interval_cuda.launches_per_body = 0
fused_interval_cuda.launches_resident = 0
fused_interval_cuda.launches_global = 0
fused_interval_cuda.last_kernel = None
fused_interval_cuda.last_cluster = None
fused_interval_cuda.last_plan = None
fused_interval_cuda.last_n_bodies = None
fused_interval_cuda.last_block_sms = None


# ---------------------------------------------------------------------------
# the interval
# ---------------------------------------------------------------------------

def fused_interval(cfg: GridConfig, geom_arrays, state: solver.FlowState,
                   jet_vel, n_steps: int, *, re=None, act_mode=None,
                   geom_id=None, cluster=None, force_global: bool = False):
    """One actuation interval with fields resident across every dt; the
    ``backend="fused"`` arm of ``solver.step_interval`` (``geom_id``: each
    env's index into the bank ``geom_arrays``; ``cluster``: the kernel's
    blocks an env, None for its own choice; ``force_global``: the
    global-memory kernel on a grid the cluster or the resident kernel
    holds).  The realization
    follows :func:`select_tier` for the state's device: a CUDA state
    launches a kernel (on either width parity) or raises, it never falls
    back to the twin or the reference loop; a CPU state on an odd width
    runs the reference loop, counted in ``kernels.FALLBACKS``."""
    per_body = solver.is_per_body(jet_vel, state.u)
    n_bodies = N_BODIES if per_body else 0
    tier = select_tier(cfg, state.u.device, n_bodies)
    if re is None:
        re = cfg.re
    # act_mode=0.0 is exact against the jets-only branch ((1-0)*jet + 0*rot
    # multiplies through exactly in float32) and keeps one kernel signature
    if act_mode is None:
        act_mode = 0.0
    if tier == "reference":
        fell_back("fused_interval", (cfg.ny, cfg.nx))
        return solver.step_interval(cfg, geom_arrays, state, jet_vel,
                                    n_steps, re=re, act_mode=act_mode,
                                    backend="reference", geom_id=geom_id)

    def launches():
        if tier != "cuda":
            return 1
        n = state.u.shape[0] if state.u.dim() == 3 else 1
        return launch_plan(cfg, n, state.u.device, n_bodies, cluster,
                           force_global).launches

    with counted("fused_interval", lambda: call_work(
            cfg, state, jet_vel, n_steps, geom_id), launches):
        if tier == "cuda":
            return fused_interval_cuda(cfg, geom_arrays, state, jet_vel,
                                       n_steps, re=re, act_mode=act_mode,
                                       geom_id=geom_id, cluster=cluster,
                                       force_global=force_global)
        return fused_interval_plain(cfg, geom_arrays, state, jet_vel,
                                    n_steps, re=re, act_mode=act_mode,
                                    geom_id=geom_id)
