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

:func:`rb_sor_planes` and the drop-in :func:`rb_sor` run ``ceil(iters /
inner_iters)`` rounds and no polish, the reference's semantics.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.cfd.poisson import (pack_checkerboard, packed_ghost_rows,
                                     packed_half_sweep, sor_coefficients,
                                     unpack_checkerboard)
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import cluster as kcluster


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
    return kcluster.fitting_clusters(ny, lambda c: smem_bytes(ny, bxp, c),
                                     SMEM_PER_BLOCK)


def _check_fit(ny: int, bxp: int) -> None:
    """``ValueError`` unless a cluster of at most 16 blocks holds a ``(ny,
    bxp)`` slab of packed planes, one band per block."""
    if not _fitting_clusters(ny, bxp):
        c = max(c for c in kcluster.CLUSTER_SIZES if c <= ny)
        raise ValueError(
            f"a ({ny}, {bxp}) slab of packed planes needs "
            f"{smem_bytes(ny, bxp, c)} bytes of shared memory per block in a "
            f"cluster of {c} blocks, over the {SMEM_PER_BLOCK}-byte limit of "
            f"one block; use more slabs")


def check_planes(ny: int, w: int, nslabs: int) -> int:
    """The slab width of ``(ny, w)`` packed planes in ``nslabs`` slabs;
    ``ValueError`` unless the kernel can serve them: the slabs split the
    width, and a slab cut into 16 bands fits one block's shared memory per
    band (every grid up to res 70 at the default aspect; res 71, whose
    width the reference's slab count leaves in one slab, does not)."""
    bxp = _check_slabs(w, nslabs)
    _check_fit(ny, bxp)
    return bxp


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


# the two slab kernels of csrc/sor_slabs.cuh: library, launch export and
# occupancy query, by the layout of their operands
_LIBS = {False: ("poisson_sor", "rb_sor_slabs_packed_launch",
                 "rb_sor_packed_max_clusters"),
         True: ("poisson_sor_full", "rb_sor_slabs_full_launch",
                "rb_sor_full_max_clusters")}


def _load(full: bool = False):
    from repro_torch.kernels import build
    name, launch, query = _LIBS[full]
    lib = build.load(name)
    if getattr(lib, launch).argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # the operand pointers (4 planes and 2 outputs, or p, rhs and the
        # output), block_sm, then sor_slabs.cuh launch_sor_slabs's
        n_ptr = 4 if full else 7
        getattr(lib, launch).argtypes = (
            [p] * n_ptr + [i] * 7 + [p] + [i] * 4 + [f] * 5 + [p])
        getattr(lib, launch).restype = ctypes.c_int
        getattr(lib, query).argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
        getattr(lib, query).restype = ctypes.c_int
    return lib


def _launch_shape(ny: int, bxp: int, cluster: int) -> tuple:
    """(band starts, rows of the largest band, threads, lanes a row)."""
    starts = kcluster.band_starts(ny, cluster)
    rows = kcluster.rows_max(starts)
    return (starts, rows, *kcluster.block_shape(bxp, rows))


def active_clusters(dev, ny: int, bxp: int, size: int,
                    full: bool = False) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``size`` blocks on ``(ny,
    bxp)`` slabs of packed planes (``full``: of the full-grid kernel, on
    slabs of ``2 * bxp`` grid columns), read once per shape and card."""
    threads = _launch_shape(ny, bxp, size)[2]
    return kcluster.active_clusters(
        _load(full), _LIBS[full][2], dev, (ny, bxp), size, threads,
        smem_bytes(ny, bxp, size))


def cluster_for(ny: int, w: int, nslabs: int, n_env: int, device,
                full: bool = False) -> int:
    """The cluster size :func:`rb_sor_slabs_packed_cuda` (``full``:
    :func:`rb_sor_slabs_cuda`) launches with for ``n_env`` envs of ``(ny,
    w)`` packed planes in ``nslabs`` slabs on the card of ``device``
    (:func:`choose_cluster` fed its SM count and occupancy)."""
    bxp = check_planes(ny, w, nslabs)
    dev = torch.device(device)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = n_env * nslabs
    active = {c: active_clusters(dev, ny, bxp, c, full) for c in (16, 8, 4, 2)
              if c in _fitting_clusters(ny, bxp) and groups * c <= n_sm}
    return choose_cluster(ny, bxp, groups, n_sm, active)


_LAUNCH_CONFIGS = {}


def _launch_config(dev, ny: int, w: int, nslabs: int, n_env: int,
                   cluster, full: bool = False) -> tuple:
    """(cluster, band starts as a C array, rows of the largest band,
    threads, lanes a row, shared-memory bytes) of a launch on ``(ny, w)``
    packed planes, worked out once per kernel, card, shape, env count and
    requested cluster size (None: the wrapper's choice), so a solve's host
    work is the launch itself."""
    key = (full, dev.index, ny, w, nslabs, n_env, cluster)
    if key not in _LAUNCH_CONFIGS:
        bxp = check_planes(ny, w, nslabs)
        if cluster is None:
            cluster = cluster_for(ny, w, nslabs, n_env, dev, full)
        elif cluster not in _fitting_clusters(ny, bxp):
            raise ValueError(f"a cluster of {cluster} blocks cannot hold a "
                             f"({ny}, {bxp}) slab in shared memory; sizes "
                             f"that fit: {_fitting_clusters(ny, bxp)}")
        starts, rows, threads, tx = _launch_shape(ny, bxp, cluster)
        _LAUNCH_CONFIGS[key] = (cluster, (ctypes.c_int * len(starts))(*starts),
                                rows, threads, tx,
                                smem_bytes(ny, bxp, cluster))
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


def _launch(full: bool, operands, outs, *, ny: int, w: int, dx: float,
            dy: float, omega: float, nslabs: int, inner_iters: int,
            rounds: int, cluster, what: str):
    """Launch a slab kernel on ``operands`` into ``outs``; returns (cluster
    size, the record of the SM each block ran on)."""
    from repro_torch.kernels.build import check_launch
    dev = operands[0].device
    n = operands[0].shape[0]
    cluster, starts, rows, threads, tx, smem = _launch_config(
        dev, ny, w, nslabs, n, cluster, full)
    block_sms = torch.empty(n * nslabs * cluster, dtype=torch.int32,
                            device=dev)
    _, _, inv_diag = sor_coefficients(dx, dy)
    lib = _load(full)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _LIBS[full][1])(
            *(t.data_ptr() for t in operands + outs), block_sms.data_ptr(),
            n, ny, 2 * w if full else w, nslabs, inner_iters, rounds,
            cluster, ctypes.cast(starts, ctypes.c_void_p), rows, threads, tx,
            smem, 1.0 / dx ** 2, 1.0 / dy ** 2, inv_diag, omega, 1.0 - omega,
            stream)
    check_launch(lib, err, what)
    return cluster, block_sms


def rb_sor_slabs_packed_cuda(red, black, rhs_r, rhs_b, *, dx: float,
                             dy: float, omega: float, nslabs: int,
                             inner_iters: int, rounds: int = 1,
                             cluster=None):
    """One launch of ``csrc/poisson_sor.cu``: ``rounds`` block-Jacobi
    rounds (more than one only with one slab), one cluster of ``cluster``
    blocks per (env, slab), by default :func:`cluster_for`'s choice.  Each
    launch records its cluster size (``.last_cluster``) and the SM each
    block ran on (``.last_block_sms``, int32, one per block, -1 where
    none ran)."""
    dev = red.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_packed_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take the plain twin")
    ny, w = red.shape[-2:]
    _check_rounds(rounds, nslabs)
    planes = _operands(red, (("red", red), ("black", black), ("rhs_r", rhs_r),
                             ("rhs_b", rhs_b)))
    outs = [torch.empty_like(planes[0]), torch.empty_like(planes[1])]
    cluster, block_sms = _launch(
        False, planes, outs, ny=ny, w=w, dx=dx, dy=dy, omega=omega,
        nslabs=nslabs, inner_iters=inner_iters, rounds=rounds,
        cluster=cluster, what="rb_sor_slabs_packed")
    rb_sor_slabs_packed_cuda.launches += 1
    rb_sor_slabs_packed_cuda.last_cluster = cluster
    rb_sor_slabs_packed_cuda.last_block_sms = block_sms
    return tuple(o.reshape(red.shape) for o in outs)


rb_sor_slabs_packed_cuda.launches = 0
rb_sor_slabs_packed_cuda.last_cluster = None
rb_sor_slabs_packed_cuda.last_block_sms = None


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


def rb_sor_planes(red, black, rhs_r, rhs_b, dx, dy, *, iters: int = 60,
                  omega: float = 1.7, nslabs: int = 0, inner_iters: int = 4):
    """``iters`` SOR iterations on packed planes as outer block-Jacobi
    rounds of ``inner_iters`` sweep pairs each (``ceil(iters /
    inner_iters)`` rounds, so the pair count rounds up); on the card one
    launch per solve where the planes take one slab."""
    w = red.shape[-1]
    if nslabs == 0:
        nslabs = _pick_nslabs(2 * w)
    outer = -(-iters // inner_iters) if iters > 0 else 0
    if outer == 0:
        return red, black
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
    ``ValueError`` unless the full-grid kernel can serve it: even slabs,
    and a slab cut into 16 bands fits one block's shared memory per band
    (every grid up to res 70 at the default aspect, as the packed kernel;
    res 71 does not)."""
    bx = _check_full_slabs(nx, nslabs)
    _check_fit(ny, bx // 2)
    return bx


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
                      cluster=None):
    """One launch of ``csrc/poisson_sor_full.cu``: ``rounds`` block-Jacobi
    rounds (more than one only with one slab), one cluster of ``cluster``
    blocks per (grid, slab), by default :func:`cluster_for`'s choice for
    the grid's packed planes.  Each launch records its cluster size
    (``.last_cluster``) and the SM each block ran on (``.last_block_sms``,
    int32, one per block, -1 where none ran)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    ny, nx = p.shape[-2:]
    check_grid(ny, nx, nslabs)
    _check_rounds(rounds, nslabs)
    pf, rf = _operands(p, (("p", p), ("rhs", rhs)))
    out = torch.empty_like(pf)
    cluster, block_sms = _launch(
        True, [pf, rf], [out], ny=ny, w=nx // 2, dx=dx, dy=dy, omega=omega,
        nslabs=nslabs, inner_iters=inner_iters, rounds=rounds,
        cluster=cluster, what="rb_sor_slabs")
    rb_sor_slabs_cuda.launches += 1
    rb_sor_slabs_cuda.last_cluster = cluster
    rb_sor_slabs_cuda.last_block_sms = block_sms
    return out.reshape(p.shape)


rb_sor_slabs_cuda.launches = 0
rb_sor_slabs_cuda.last_cluster = None
rb_sor_slabs_cuda.last_block_sms = None


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
    where the grid is one slab.  Raises ``ValueError`` on an odd width."""
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
    return rb_sor_slabs(p, rhs, dx=dx, dy=dy, omega=omega, nslabs=nslabs,
                        inner_iters=inner_iters, rounds=outer)
