"""Fused actuation-interval path: ``backend="fused"`` for the env hot loop.

Port of ``repro.kernels.actuation.ops``.  One actuation interval
(``steps_per_action`` dt's) runs with the velocity fields and both packed
pressure parity planes carried across every dt:

- on a CUDA tensor, one launch of the hand-written kernel
  ``csrc/fused_interval.cu`` for the whole env batch, one thread-block
  cluster per env, the dt loop inside the kernel
  (:func:`fused_interval_cuda`);
- on a CPU tensor, its plain PyTorch twin (:func:`fused_interval_plain`),
  which chains the solver's own ``_momentum`` -> packed SOR projection
  -> velocity correction, so the twin cannot drift from the solver.

Tier selection (:func:`select_tier`): a CPU state on a grid of odd width
(no checkerboard parity) falls back to the reference loop, warning once
per grid shape.  A CUDA state the kernel cannot serve (odd width, or an
env's fields over the shared memory of a 16-block cluster, the analogue
of the reference's VMEM budget) raises: the card never runs the plain
loop in the kernel's place.
"""
from __future__ import annotations

import ctypes
import warnings

import torch

from repro_torch._warn import warn_once_cache
from repro_torch.cfd import poisson, solver
from repro_torch.cfd.grid import GridConfig
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.cluster import (CLUSTER_SIZES, band_starts,
                                         block_shape, rows_max)

# beside the fields: two mbarriers (4 float slots), the block's three
# partial sums (4 slots) and block_sum3's 128 reduction slots
# (csrc/fused_interval.cu)
_SCRATCH_FLOATS = 4 + 4 + 128

_FALLBACK_WARNED = warn_once_cache()


def smem_bytes(ny: int, nx: int, cluster: int) -> int:
    """Dynamic shared-memory bytes of one block when an env of an (ny, nx)
    grid spreads over ``cluster`` blocks: the block's band (the largest of
    the partition) of u, v, u_pen, v_pen and the four packed planes, with
    their halo rows, the halo exchange's mbarriers and the reduction
    slots."""
    r = rows_max(band_starts(ny, cluster))
    w = nx // 2
    floats = ((r + 2) * (nx + 1)      # u, halo rows above and below
              + (r + 3) * nx          # v, halo above, below and the wall
              + r * nx                # u_pen (its outlet column implied)
              + (r + 1) * nx          # v_pen, halo below / wall row
              + 2 * (r + 2) * w       # red, black
              + 2 * r * w             # rhs_r, rhs_b
              + _SCRATCH_FLOATS)
    return 4 * floats


def _fitting_clusters(ny: int, nx: int, smem_per_block: int) -> list:
    return kcluster.fitting_clusters(
        ny, lambda c: smem_bytes(ny, nx, c), smem_per_block)


def choose_cluster(ny: int, nx: int, n_env: int, n_sm: int, active,
                   smem_per_block: int) -> int:
    """The cluster size for ``n_env`` envs on an (ny, nx) grid:
    :func:`repro_torch.kernels.cluster.choose_cluster` over the sizes
    whose band of this kernel's fields fits one block."""
    fits = _fitting_clusters(ny, nx, smem_per_block)
    if not fits:
        raise ValueError(f"no cluster of up to {CLUSTER_SIZES[-1]} blocks "
                         f"holds grid (ny={ny}, nx={nx})")
    return kcluster.choose_cluster(fits, n_env, n_sm, active)


def check_kernel_grid(cfg: GridConfig) -> None:
    """Raise ``ValueError`` unless the CUDA kernel can serve the grid: an
    even width, and one env's fields, cut into 16 bands, within the shared
    memory of one block each (res <= 38 at the default aspect)."""
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        raise ValueError(
            f"backend='fused' needs an even grid width for packed "
            f"checkerboard parity, got grid (ny={ny}, nx={nx}); use "
            f"backend='reference' for this grid")
    if not _fitting_clusters(ny, nx, SMEM_PER_BLOCK):
        c = max(c for c in CLUSTER_SIZES if c <= ny)
        raise ValueError(
            f"backend='fused' keeps one env's fields in the shared memory of "
            f"a cluster of up to {CLUSTER_SIZES[-1]} blocks: grid (ny={ny}, "
            f"nx={nx}) needs {smem_bytes(ny, nx, c)} bytes per block at {c} "
            f"blocks, over the {SMEM_PER_BLOCK} a block may have; run this "
            f"grid with backend='reference'")


def select_tier(cfg: GridConfig, device) -> str:
    """Which realization serves ``backend="fused"`` for tensors on ``device``.

    "cuda"       CUDA tensors: the hand-written kernel; a grid it cannot
                 serve raises (:func:`check_kernel_grid`)
    "plain"      CPU tensors: its plain PyTorch twin
    "reference"  CPU tensors on a grid of odd width (warns once per shape)
    """
    if torch.device(device).type == "cuda":
        check_kernel_grid(cfg)
        return "cuda"
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        if ("odd_nx", ny, nx) not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(("odd_nx", ny, nx))
            warnings.warn(
                f"backend='fused' needs an even grid width for packed "
                f"checkerboard parity; grid (ny={ny}, nx={nx}) falls back "
                f"to the reference loop (this warning fires once per shape)",
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
                         n_steps: int, *, re=None, act_mode=None):
    """The kernel's plain PyTorch twin: ``fused_dt`` looped ``n_steps``
    times, the planes packed once before and unpacked once after."""
    ga = solver.GeomArrays(*geom_arrays)
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
    return flow, solver.StepOutputs(cd=torch.stack(cds, dim=-1),
                                    cl=torch.stack(cls, dim=-1))


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
            [p] * 13 + [i] * 7 + [p] + [i] * 4 + [p, p])
        lib.fused_interval_launch.restype = ctypes.c_int
        lib.fused_interval_max_clusters.argtypes = [
            i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.fused_interval_max_clusters.restype = ctypes.c_int
    return lib


def active_clusters(dev, cfg: GridConfig, size: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the launch shape of ``size``
    blocks on ``cfg``'s grid, read once per shape and card."""
    threads, _ = block_shape(cfg.nx // 2, rows_max(band_starts(cfg.ny,
                                                               size)))
    return kcluster.active_clusters(
        _load(), "fused_interval_max_clusters", dev, (cfg.ny, cfg.nx), size,
        threads, smem_bytes(cfg.ny, cfg.nx, size))


def cluster_for(cfg: GridConfig, n_env: int, device) -> int:
    """The cluster size :func:`fused_interval_cuda` launches with for
    ``n_env`` envs on the card of ``device`` (:func:`choose_cluster` fed
    the card's SM count and occupancy)."""
    check_kernel_grid(cfg)
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = _fitting_clusters(cfg.ny, cfg.nx, SMEM_PER_BLOCK)
    active = {c: active_clusters(dev, cfg, c) for c in (16, 8, 4, 2)
              if c in fits and n_env * c <= n_sm}
    return choose_cluster(cfg.ny, cfg.nx, n_env, n_sm, active,
                          SMEM_PER_BLOCK)


def fused_interval_cuda(cfg: GridConfig, geom_arrays, state, jet_vel,
                        n_steps: int, *, re=None, act_mode=None,
                        cluster=None):
    """One launch of ``csrc/fused_interval.cu`` for the whole env batch:
    ``n_steps`` dt's, returns ``(FlowState, StepOutputs)`` with
    ``(N, n_steps)`` C_D / C_L (``(n_steps,)`` for an unbatched state).
    Each env runs on a cluster of ``cluster`` blocks, by default
    :func:`cluster_for`'s choice; a size whose bands do not fit one
    block's shared memory raises.  Each launch records its cluster size
    (``fused_interval_cuda.last_cluster``) and the SM each block ran on
    (``fused_interval_cuda.last_block_sms``, int32, one per block, -1 where
    none ran)."""
    u, v, p = state
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"fused_interval_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take fused_interval_plain")
    check_kernel_grid(cfg)
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
    if cluster is None:
        cluster = cluster_for(cfg, n, dev)
    elif cluster not in _fitting_clusters(ny, nx, SMEM_PER_BLOCK):
        raise ValueError(f"a cluster of {cluster} blocks cannot hold grid "
                         f"(ny={ny}, nx={nx}) in shared memory; sizes that "
                         f"fit: {_fitting_clusters(ny, nx, SMEM_PER_BLOCK)}")
    starts = band_starts(ny, cluster)
    rows = rows_max(starts)
    threads, tx = block_shape(nx // 2, rows)
    ga = solver.GeomArrays(*geom_arrays)
    geom = [g.to(dev, torch.float32).contiguous() for g in ga]
    u, v, p = u.contiguous(), v.contiguous(), p.contiguous()
    jet = _per_env_vector(jet_vel, n, dev)
    re_t = _per_env_vector(cfg.re if re is None else re, n, dev)
    mode = _per_env_vector(0.0 if act_mode is None else act_mode, n, dev)
    u_out, v_out, p_out = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(p))
    cd = torch.empty((n, n_steps), dtype=torch.float32, device=dev)
    cl = torch.empty_like(cd)
    block_sms = torch.empty(n * cluster, dtype=torch.int32, device=dev)
    geom_ptrs = (ctypes.c_void_p * len(geom))(*[g.data_ptr() for g in geom])
    starts_c = (ctypes.c_int * len(starts))(*starts)
    consts = _consts(cfg)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_interval_launch(
            u.data_ptr(), v.data_ptr(), p.data_ptr(),
            ctypes.cast(geom_ptrs, ctypes.c_void_p), jet.data_ptr(),
            re_t.data_ptr(), mode.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), p_out.data_ptr(), cd.data_ptr(),
            cl.data_ptr(), block_sms.data_ptr(), n, ny, nx, n_steps,
            cfg.poisson_iters, poisson.n_polish(cfg.poisson_iters), cluster,
            ctypes.cast(starts_c, ctypes.c_void_p), rows, threads, tx,
            smem_bytes(ny, nx, cluster), ctypes.cast(consts, ctypes.c_void_p),
            stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "fused_interval")
    fused_interval_cuda.launches += 1
    fused_interval_cuda.last_cluster = cluster
    fused_interval_cuda.last_block_sms = block_sms
    flow = solver.FlowState(u_out, v_out, p_out)
    if not batched:
        flow = solver.FlowState(*(a[0] for a in flow))
        cd, cl = cd[0], cl[0]
    return flow, solver.StepOutputs(cd=cd, cl=cl)


fused_interval_cuda.launches = 0
fused_interval_cuda.last_cluster = None
fused_interval_cuda.last_block_sms = None


# ---------------------------------------------------------------------------
# the interval
# ---------------------------------------------------------------------------

def fused_interval(cfg: GridConfig, geom_arrays, state: solver.FlowState,
                   jet_vel, n_steps: int, *, re=None, act_mode=None):
    """One actuation interval with fields resident across every dt; the
    ``backend="fused"`` arm of ``solver.step_interval``.  The realization
    follows :func:`select_tier` for the state's device: a CUDA state
    launches the kernel or raises, it never falls back to the twin or the
    reference loop."""
    tier = select_tier(cfg, state.u.device)
    if re is None:
        re = cfg.re
    # act_mode=0.0 is exact against the jets-only branch ((1-0)*jet + 0*rot
    # multiplies through exactly in float32) and keeps one kernel signature
    if act_mode is None:
        act_mode = 0.0
    if tier == "reference":
        return solver.step_interval(cfg, geom_arrays, state, jet_vel,
                                    n_steps, re=re, act_mode=act_mode,
                                    backend="reference")
    if tier == "cuda":
        return fused_interval_cuda(cfg, geom_arrays, state, jet_vel, n_steps,
                                   re=re, act_mode=act_mode)
    return fused_interval_plain(cfg, geom_arrays, state, jet_vel, n_steps,
                                re=re, act_mode=act_mode)
