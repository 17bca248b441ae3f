"""Fused actuation-interval path: ``backend="fused"`` for the env hot loop.

Port of ``repro.kernels.actuation.ops``.  One actuation interval
(``steps_per_action`` dt's) runs with the velocity fields and both packed
pressure parity planes carried across every dt:

- on a CUDA tensor, one launch of the hand-written kernel
  ``csrc/fused_interval.cu`` for the whole env batch, one thread-block
  cluster per env, the dt loop inside the kernel
  (:func:`fused_interval_cuda`): its scalar instantiation for a scalar
  amplitude, its per-body one (``max_bodies()`` bodies, each env reading
  its own geometry from a bank) for a per-body vector;
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
from repro_torch.cfd.grid import GridConfig, max_bodies
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.cluster import (CLUSTER_SIZES, band_starts,
                                         block_shape, rows_max)

# the body count of the kernel's per-body instantiation
# (csrc/fused_interval.cu kBodies): the widest registered geometry
N_BODIES = max_bodies()

_FALLBACK_WARNED = warn_once_cache()


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
    slots; ``n_bodies`` is the instantiation's body count (0: scalar)."""
    r = rows_max(band_starts(ny, cluster))
    w = nx // 2
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


def check_kernel_grid(cfg: GridConfig, n_bodies: int = 0) -> None:
    """Raise ``ValueError`` unless the CUDA kernel's instantiation for
    ``n_bodies`` (0: scalar) can serve the grid: an even width, and one
    env's fields, cut into 16 bands, within the shared memory of one block
    each (res <= 38 at the default aspect, either instantiation)."""
    ny, nx = cfg.ny, cfg.nx
    if nx % 2:
        raise ValueError(
            f"backend='fused' needs an even grid width for packed "
            f"checkerboard parity, got grid (ny={ny}, nx={nx}); use "
            f"backend='reference' for this grid")
    if not _fitting_clusters(ny, nx, SMEM_PER_BLOCK, n_bodies):
        c = max(c for c in CLUSTER_SIZES if c <= ny)
        raise ValueError(
            f"backend='fused' keeps one env's fields in the shared memory of "
            f"a cluster of up to {CLUSTER_SIZES[-1]} blocks: grid (ny={ny}, "
            f"nx={nx}) needs {smem_bytes(ny, nx, c, n_bodies)} bytes per "
            f"block at {c} blocks, over the {SMEM_PER_BLOCK} a block may "
            f"have; run this grid with backend='reference'")


def select_tier(cfg: GridConfig, device, n_bodies: int = 0) -> str:
    """Which realization serves ``backend="fused"`` for tensors on ``device``.

    "cuda"       CUDA tensors: the hand-written kernel (its instantiation
                 for ``n_bodies``, 0: scalar); a grid it cannot serve
                 raises (:func:`check_kernel_grid`)
    "plain"      CPU tensors: its plain PyTorch twin
    "reference"  CPU tensors on a grid of odd width (warns once per shape)
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
    return lib


def active_clusters(dev, cfg: GridConfig, size: int, n_bodies: int = 0
                    ) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the launch shape of ``size``
    blocks on ``cfg``'s grid (the instantiation for ``n_bodies``, 0:
    scalar), read once per shape and card."""
    threads, _ = block_shape(cfg.nx // 2, rows_max(band_starts(cfg.ny,
                                                               size)))
    query = ("fused_interval_bodies_max_clusters" if n_bodies
             else "fused_interval_max_clusters")
    return kcluster.active_clusters(
        _load(), query, dev, (cfg.ny, cfg.nx), size, threads,
        smem_bytes(cfg.ny, cfg.nx, size, n_bodies))


def cluster_for(cfg: GridConfig, n_env: int, device, n_bodies: int = 0
                ) -> int:
    """The cluster size :func:`fused_interval_cuda` launches with for
    ``n_env`` envs on the card of ``device`` (:func:`choose_cluster` fed
    the card's SM count and occupancy)."""
    check_kernel_grid(cfg, n_bodies)
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = _fitting_clusters(cfg.ny, cfg.nx, SMEM_PER_BLOCK, n_bodies)
    active = {c: active_clusters(dev, cfg, c, n_bodies) for c in (16, 8, 4, 2)
              if c in fits and n_env * c <= n_sm}
    return choose_cluster(cfg.ny, cfg.nx, n_env, n_sm, active,
                          SMEM_PER_BLOCK, n_bodies)


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
                        cluster=None, geom_id=None):
    """One launch of ``csrc/fused_interval.cu`` for the whole env batch:
    ``n_steps`` dt's, returns ``(FlowState, StepOutputs)`` with
    ``(N, n_steps)`` C_D / C_L (``(n_steps,)`` for an unbatched state).

    A per-body ``jet_vel`` (``(N, A)``, ``solver.is_per_body``) launches the
    per-body instantiation (``N_BODIES`` bodies) and gives ``(N, n_steps,
    B)`` coefficients for the geometry's B bodies; ``geom_id`` (``(N,)``)
    makes ``geom_arrays`` a bank from which each env reads its own
    geometry.  A scalar amplitude launches the scalar instantiation on one
    geometry.  A call the kernel cannot serve raises.

    Each env runs on a cluster of ``cluster`` blocks, by default
    :func:`cluster_for`'s choice; a size whose bands do not fit one
    block's shared memory raises.  Each launch records its cluster size
    (``fused_interval_cuda.last_cluster``), the instantiation's body count
    (``last_n_bodies``, 0: scalar) and the SM each block ran on
    (``last_block_sms``, int32, one per block, -1 where none ran);
    ``launches`` counts every launch, ``launches_per_body`` those of the
    per-body instantiation."""
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
    fits = _fitting_clusters(ny, nx, SMEM_PER_BLOCK, n_bodies)
    if cluster is None:
        cluster = cluster_for(cfg, n, dev, n_bodies)
    elif cluster not in fits:
        raise ValueError(f"a cluster of {cluster} blocks cannot hold grid "
                         f"(ny={ny}, nx={nx}) in shared memory; sizes that "
                         f"fit: {fits}")
    starts = band_starts(ny, cluster)
    rows = rows_max(starts)
    threads, tx = block_shape(nx // 2, rows)
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
    u_out, v_out, p_out = (torch.empty_like(u), torch.empty_like(v),
                           torch.empty_like(p))
    cd = torch.empty(out_shape, dtype=torch.float32, device=dev)
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
            ctypes.cast(geom_ptrs, ctypes.c_void_p),
            None if gid is None else gid.data_ptr(), n_bodies,
            jet.data_ptr(), re_t.data_ptr(), mode.data_ptr(),
            u_out.data_ptr(), v_out.data_ptr(), p_out.data_ptr(),
            cd.data_ptr(), cl.data_ptr(), block_sms.data_ptr(), n, ny, nx,
            n_steps, cfg.poisson_iters, poisson.n_polish(cfg.poisson_iters),
            cluster, ctypes.cast(starts_c, ctypes.c_void_p), rows, threads,
            tx, smem_bytes(ny, nx, cluster, n_bodies),
            ctypes.cast(consts, ctypes.c_void_p), stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "fused_interval")
    fused_interval_cuda.launches += 1
    fused_interval_cuda.launches_per_body += bool(per_body)
    fused_interval_cuda.last_cluster = cluster
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
fused_interval_cuda.last_cluster = None
fused_interval_cuda.last_n_bodies = None
fused_interval_cuda.last_block_sms = None


# ---------------------------------------------------------------------------
# the interval
# ---------------------------------------------------------------------------

def fused_interval(cfg: GridConfig, geom_arrays, state: solver.FlowState,
                   jet_vel, n_steps: int, *, re=None, act_mode=None,
                   geom_id=None, cluster=None):
    """One actuation interval with fields resident across every dt; the
    ``backend="fused"`` arm of ``solver.step_interval`` (``geom_id``: each
    env's index into the bank ``geom_arrays``; ``cluster``: the kernel's
    cluster size, None for its own choice).  The realization follows
    :func:`select_tier` for the state's device: a CUDA state launches the
    kernel or raises, it never falls back to the twin or the reference
    loop."""
    per_body = solver.is_per_body(jet_vel, state.u)
    tier = select_tier(cfg, state.u.device, N_BODIES if per_body else 0)
    if re is None:
        re = cfg.re
    # act_mode=0.0 is exact against the jets-only branch ((1-0)*jet + 0*rot
    # multiplies through exactly in float32) and keeps one kernel signature
    if act_mode is None:
        act_mode = 0.0
    if tier == "reference":
        return solver.step_interval(cfg, geom_arrays, state, jet_vel,
                                    n_steps, re=re, act_mode=act_mode,
                                    backend="reference", geom_id=geom_id)
    if tier == "cuda":
        return fused_interval_cuda(cfg, geom_arrays, state, jet_vel, n_steps,
                                   re=re, act_mode=act_mode, geom_id=geom_id,
                                   cluster=cluster)
    return fused_interval_plain(cfg, geom_arrays, state, jet_vel, n_steps,
                                re=re, act_mode=act_mode, geom_id=geom_id)
