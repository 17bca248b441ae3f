"""Pressure Poisson solver: red-black SOR with channel boundary conditions.

Port of ``repro.cfd.poisson``.  BCs: Neumann (dp/dn = 0) at the inlet and
walls, Dirichlet (p = 0) at the outlet.  Every function acts on planes with
any number of leading env dims, ``(..., ny, W)``.  ``solve`` fans out over
the backends:

  "reference"  packed on even-width grids, full-grid on odd widths
  "packed"     packed-checkerboard storage: red and black points as two
               (ny, nx//2) planes; even nx only
  "full"       the original full-grid masked sweep (the oracle)
  "pallas"     the packed-SOR slab kernel (``repro_torch.kernels.poisson``),
               named as in ``repro`` so both packages' backend names match:
               the hand-written CUDA kernel on CUDA tensors, its plain twin
               on CPU tensors; on an odd width the full-grid kernel's full
               sweeps on CUDA tensors, the reference path on CPU ones
  "halo"       the explicit x-slab decomposition with halo messages
               (``cfd/decomp.py``) over a mesh's "model" axis: the
               paper's N_ranks > 1 configuration
  "fused"      an actuation-interval option (``solver.step_interval``); a
               single ``solve`` runs "reference"

Packed-checkerboard index map (nx even; row j, packed column k):

  red[j, k]   = p[j, 2k + j%2]          black[j, k] = p[j, 2k + 1 - j%2]
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch._warn import warn_once_cache

BACKENDS = ("reference", "packed", "full", "pallas", "halo", "fused")

# pairs at the end of a solve swept with omega = 1 (the polish tail)
POLISH = 10

# grid shapes already warned about for the pallas -> reference odd-width
# fallback (once per shape; reset by repro_torch._warn.reset_warning_caches)
_ODD_NX_WARNED = warn_once_cache()


def n_polish(iters: int, polish: int = POLISH) -> int:
    """How many of a solve's ``iters`` pairs are polish pairs; shared by
    every backend and by the fused-interval kernel."""
    return min(polish, iters // 2)


def resolve_backend(backend: Optional[str] = None) -> str:
    backend = "reference" if backend is None else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown solver backend {backend!r}; choose from "
                         f"{BACKENDS}")
    return backend


def _row_odd(ny: int, device) -> torch.Tensor:
    return (torch.arange(ny, device=device) % 2 == 1)[:, None]


def _pad_pressure(p):
    """Ghost cells: Neumann left/top/bottom, Dirichlet 0 at right (outlet)."""
    p = torch.cat([p[..., :, :1], p, -p[..., :, -1:]], dim=-1)
    return torch.cat([p[..., :1, :], p, p[..., -1:, :]], dim=-2)


def residual(p, rhs, dx, dy):
    pp = _pad_pressure(p)
    lap = ((pp[..., 1:-1, :-2] + pp[..., 1:-1, 2:] - 2 * p) / dx ** 2
           + (pp[..., :-2, 1:-1] + pp[..., 2:, 1:-1] - 2 * p) / dy ** 2)
    return lap - rhs


# ---------------------------------------------------------------------------
# packed checkerboard layout
# ---------------------------------------------------------------------------

def pack_checkerboard(a):
    """(..., ny, nx) full grid -> ((..., ny, nx//2) red, black) planes."""
    ny, nx = a.shape[-2:]
    if nx % 2:
        raise ValueError(f"packed checkerboard needs an even grid width, "
                         f"got nx={nx}")
    pairs = a.reshape(*a.shape[:-1], nx // 2, 2)
    odd = _row_odd(ny, a.device)
    red = torch.where(odd, pairs[..., 1], pairs[..., 0])
    black = torch.where(odd, pairs[..., 0], pairs[..., 1])
    return red, black


def unpack_checkerboard(red, black):
    """Inverse of ``pack_checkerboard``."""
    ny, w = red.shape[-2:]
    odd = _row_odd(ny, red.device)[..., None]
    pairs = torch.where(odd, torch.stack([black, red], dim=-1),
                        torch.stack([red, black], dim=-1))
    return pairs.reshape(*red.shape[:-1], 2 * w)


def packed_half_sweep(active, other, rhs_a, left_g, right_g, north_g, south_g,
                      shift, om, dx2, dy2, inv_diag):
    """One colored Gauss-Seidel half-sweep entirely in packed storage.

    active/other: the plane being updated / the neighbour plane (..., ny, W).
    left_g/right_g: ghost columns (..., ny, 1) in the update parity.
    north_g/south_g: wall ghost rows (..., 1, W).  shift: (ny, 1) bool —
    rows whose horizontal neighbours sit one packed column to the right.

    The update association is load-bearing (it is the reference's):
    ``p_gs = (nb - rhs) * inv_diag`` first, then
    ``(1 - om) * active + om * p_gs``.  The CUDA kernels' shared half-sweep
    (``kernels/csrc/sor_packed.cuh``) follows the same order.
    """
    o_west = torch.cat([left_g, other[..., :, :-1]], dim=-1)
    o_east = torch.cat([other[..., :, 1:], right_g], dim=-1)
    horiz = torch.where(shift, other + o_east, o_west + other)
    north = torch.cat([north_g, other[..., :-1, :]], dim=-2)
    south = torch.cat([other[..., 1:, :], south_g], dim=-2)
    nb = horiz / dx2 + (north + south) / dy2
    p_gs = (nb - rhs_a) * inv_diag
    return (1 - om) * active + om * p_gs


def packed_ghost_rows(active, other):
    """Wall ghost row strips (..., 1, W) for the ``active`` half-sweep
    (Neumann walls: a copy of the active plane's own boundary rows)."""
    del other
    return active[..., :1, :], active[..., -1:, :]


def sor_coefficients(dx, dy):
    """(dx2, dy2, inv_diag) as the reference computes them (in float64,
    rounded to float32 where they meet a tensor)."""
    dx2, dy2 = dx ** 2, dy ** 2
    return dx2, dy2, 1.0 / (2.0 / dx2 + 2.0 / dy2)


def packed_sweep_pair(red, black, rhs_r, rhs_b, om, *, dx, dy, row_odd):
    """One red+black Gauss-Seidel pair on packed planes (single domain:
    boundary ghosts derived from the planes themselves)."""
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    red = packed_half_sweep(
        red, black, rhs_r,
        red[..., :, :1], -red[..., :, -1:],     # Neumann inlet / Dirichlet
        *packed_ghost_rows(red, black),
        row_odd, om, dx2, dy2, inv_diag)
    black = packed_half_sweep(
        black, red, rhs_b,
        black[..., :, :1], -black[..., :, -1:],
        *packed_ghost_rows(black, red),
        ~row_odd, om, dx2, dy2, inv_diag)
    return red, black


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def _full_sweeps(rhs, p, dx, dy, iters, n_sor, omega):
    ny, nx = rhs.shape[-2:]
    jj = torch.arange(ny, device=rhs.device)[:, None]
    ii = torch.arange(nx, device=rhs.device)[None, :]
    red = (ii + jj) % 2 == 0
    inv_diag = 1.0 / (2.0 / dx ** 2 + 2.0 / dy ** 2)

    def sweep(p, mask, om):
        pp = _pad_pressure(p)
        nb = ((pp[..., 1:-1, :-2] + pp[..., 1:-1, 2:]) / dx ** 2
              + (pp[..., :-2, 1:-1] + pp[..., 2:, 1:-1]) / dy ** 2)
        p_gs = (nb - rhs) * inv_diag
        return torch.where(mask, (1 - om) * p + om * p_gs, p)

    for i in range(iters):
        om = omega if i < n_sor else 1.0
        p = sweep(p, red, om)
        p = sweep(p, ~red, om)
    return p


def solve(rhs, dx, dy, *, iters: int = 60, omega: float = 1.7, p0=None,
          backend: Optional[str] = None, polish: int = POLISH, mesh=None,
          halo_axis: str = "model", halo_inner: int = 4):
    """Red-black SOR on ``(..., ny, nx)``; the last :func:`n_polish` pairs
    run with omega = 1.

    ``backend="pallas"`` runs ``ceil(n_sor / inner_iters)`` rounds of the
    slab kernel (so 52 SOR pairs where "packed" does 50 at iters=60), then
    the polish pairs on the packed planes, as ``repro`` does.  On an odd
    grid width the slab kernel has no checkerboard parity and the
    reference runs its full-grid sweep instead: a CPU tensor falls back to
    that reference path (warning once per shape, counted in
    ``kernels.FALLBACKS``), a CUDA tensor runs the same sweep in one
    launch of a hand-written kernel (``kernels.poisson.ops.full_sweeps``:
    ``iters`` pairs, no slabs and no rounds, no warning, no count).
    ``backend="halo"`` runs ``cfd/decomp``'s explicit x-slab decomposition
    over ``mesh``'s ``halo_axis`` (``halo_inner`` local sweep pairs per
    halo exchange): the paper's N_ranks > 1 configuration."""
    backend = resolve_backend(backend)
    ny, nx = rhs.shape[-2:]
    if backend == "halo":
        if mesh is None:
            raise ValueError(
                "backend='halo' needs a mesh with a spatial axis; pass "
                "mesh= (e.g. launch.mesh.mesh_for_plan(plan)) or choose "
                "backend='reference'")
        from repro_torch.cfd import decomp
        p = torch.zeros_like(rhs) if p0 is None else p0
        return decomp.decomposed_solve(rhs, p, mesh=mesh, axis=halo_axis,
                                       dx=dx, dy=dy, omega=omega,
                                       iters=iters, inner_iters=halo_inner,
                                       polish=polish)
    if backend == "fused":
        backend = "reference"
    if backend == "pallas" and nx % 2:
        if rhs.device.type == "cuda":
            from repro_torch.kernels.poisson import ops as poisson_ops
            n_pol = n_polish(iters, polish)
            return poisson_ops.full_sweeps(
                rhs, torch.zeros_like(rhs) if p0 is None else p0, dx, dy,
                iters=iters, n_sor=iters - n_pol, omega=float(omega))
        if (ny, nx) not in _ODD_NX_WARNED:
            _ODD_NX_WARNED.add((ny, nx))
            warnings.warn(
                f"backend='pallas' needs an even grid width for checkerboard "
                f"slab parity; grid (ny={ny}, nx={nx}) falls back to the "
                f"reference path (this warning fires once per shape)",
                RuntimeWarning, stacklevel=2)
        kernels.fell_back("rb_sor_slabs_packed", (ny, nx))
        backend = "reference"
    if backend == "packed" and nx % 2:
        raise ValueError(
            f"backend='packed' needs an even grid width, got nx={nx}; use "
            f"backend='reference' (it falls back to the full-grid sweep on "
            f"odd widths) or an even-nx grid")
    if backend == "reference":
        backend = "full" if nx % 2 else "packed"
    omega = float(omega)
    p = torch.zeros_like(rhs) if p0 is None else p0
    n_pol = n_polish(iters, polish)
    n_sor = iters - n_pol

    if backend == "full":
        return _full_sweeps(rhs, p, dx, dy, iters, n_sor, omega)

    rhs_r, rhs_b = pack_checkerboard(rhs)
    red, black = pack_checkerboard(p)
    row_odd = _row_odd(ny, rhs.device)
    if backend == "pallas":
        from repro_torch.kernels.poisson import ops as poisson_ops
        red, black = poisson_ops.rb_sor_planes(red, black, rhs_r, rhs_b,
                                               dx, dy, iters=n_sor,
                                               omega=omega)
        schedule = [1.0] * n_pol
    else:
        schedule = [omega if i < n_sor else 1.0 for i in range(iters)]
    for om in schedule:
        red, black = packed_sweep_pair(red, black, rhs_r, rhs_b, om,
                                       dx=dx, dy=dy, row_odd=row_odd)
    return unpack_checkerboard(red, black)
