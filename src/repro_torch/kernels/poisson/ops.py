"""Red-black SOR slab smoothers and the solves built on them.

Port of ``repro.kernels.poisson``.  Two smoothers, each one block-Jacobi
round, each on a CUDA tensor one launch of a hand-written kernel and on a
CPU tensor its plain twin:

* :func:`rb_sor_slabs_packed` (``kernel.rb_sor_slabs_packed``) on packed
  planes ``(..., ny, W)`` from ``cfd.poisson.pack_checkerboard``:
  ``csrc/poisson_sor.cu``, twin :func:`rb_sor_slabs_packed_plain`;
* :func:`rb_sor_slabs` (``kernel.rb_sor_slabs``) on the full grid ``(...,
  ny, nx)`` with a masked update: ``csrc/poisson_sor_full.cu``, twin
  :func:`rb_sor_slabs_plain` (the reference's ``ref.rb_sor_slabs_ref``).

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


def smem_bytes(ny: int, bxp: int) -> int:
    """Shared-memory bytes one block of the kernel claims for a ``(ny,
    bxp)`` slab: its four packed planes and four ghost columns."""
    return 4 * (4 * ny * bxp + 4 * ny)


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


def _load():
    from repro_torch.kernels import build
    lib = build.load("poisson_sor")
    if lib.rb_sor_slabs_packed_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rb_sor_slabs_packed_launch.argtypes = (
            [p] * 6 + [i] * 6 + [f] * 5 + [p])
        lib.rb_sor_slabs_packed_launch.restype = ctypes.c_int
    return lib


def rb_sor_slabs_packed_cuda(red, black, rhs_r, rhs_b, *, dx: float,
                             dy: float, omega: float, nslabs: int,
                             inner_iters: int):
    """One launch of ``csrc/poisson_sor.cu``: grid (nslabs, n_env)."""
    dev = red.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_packed_cuda needs CUDA tensors, got "
                         f"{dev}; CPU tensors take the plain twin")
    ny, w = red.shape[-2:]
    bxp = _check_slabs(w, nslabs)
    smem = smem_bytes(ny, bxp)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a ({ny}, {bxp}) slab needs {smem} bytes of shared "
                         f"memory, over the {SMEM_PER_BLOCK}-byte limit of "
                         f"one block; use more slabs")
    lead = red.shape[:-2]
    planes = []
    for name, t in (("red", red), ("black", black), ("rhs_r", rhs_r),
                    ("rhs_b", rhs_b)):
        if t.shape != red.shape or t.dtype != torch.float32 \
                or t.device != dev:
            raise ValueError(f"{name}: expected float32 {tuple(red.shape)} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        planes.append(t.reshape(-1, ny, w).contiguous())
    n = planes[0].shape[0]
    out_r, out_b = torch.empty_like(planes[0]), torch.empty_like(planes[1])
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rb_sor_slabs_packed_launch(
            *(t.data_ptr() for t in planes), out_r.data_ptr(),
            out_b.data_ptr(), n, ny, w, nslabs, inner_iters, smem, dx2,
            dy2, inv_diag, omega, 1.0 - omega, stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "rb_sor_slabs_packed")
    rb_sor_slabs_packed_cuda.launches += 1
    return out_r.reshape(*lead, ny, w), out_b.reshape(*lead, ny, w)


rb_sor_slabs_packed_cuda.launches = 0


def rb_sor_slabs_packed(red, black, rhs_r, rhs_b, *, dx: float, dy: float,
                        omega: float, nslabs: int, inner_iters: int):
    """One outer block-Jacobi round on packed planes, all slabs in
    parallel: the kernel on CUDA tensors, the plain twin on CPU tensors."""
    kw = dict(dx=float(dx), dy=float(dy), omega=float(omega), nslabs=nslabs,
              inner_iters=inner_iters)
    if red.device.type == "cuda":
        return rb_sor_slabs_packed_cuda(red, black, rhs_r, rhs_b, **kw)
    return rb_sor_slabs_packed_plain(red, black, rhs_r, rhs_b, **kw)


def rb_sor_planes(red, black, rhs_r, rhs_b, dx, dy, *, iters: int = 60,
                  omega: float = 1.7, nslabs: int = 0, inner_iters: int = 4):
    """``iters`` SOR iterations on packed planes as outer block-Jacobi
    rounds of ``inner_iters`` sweep pairs each (``ceil(iters /
    inner_iters)`` rounds, so the pair count rounds up)."""
    w = red.shape[-1]
    if nslabs == 0:
        nslabs = _pick_nslabs(2 * w)
    outer = -(-iters // inner_iters) if iters > 0 else 0
    for _ in range(outer):
        red, black = rb_sor_slabs_packed(red, black, rhs_r, rhs_b, dx=dx,
                                         dy=dy, omega=omega, nslabs=nslabs,
                                         inner_iters=inner_iters)
    return red, black


# ---------------------------------------------------------------------------
# full-grid slab smoother (rb_sor(packed=False))
# ---------------------------------------------------------------------------

def _check_full_slabs(nx: int, nslabs: int) -> int:
    if nslabs <= 0 or nx % nslabs or (nx // nslabs) % 2:
        raise ValueError(f"grid width {nx} does not split into {nslabs} "
                         f"slabs of even width")
    return nx // nslabs


def full_smem_bytes(ny: int, bx: int) -> int:
    """Shared-memory bytes one block of the full-grid kernel claims for a
    ``(ny, bx)`` slab: its p and rhs and two ghost columns."""
    return 4 * (2 * ny * bx + 2 * ny)


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


def _load_full():
    from repro_torch.kernels import build
    lib = build.load("poisson_sor_full")
    if lib.rb_sor_slabs_full_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rb_sor_slabs_full_launch.argtypes = (
            [p] * 3 + [i] * 6 + [f] * 5 + [p])
        lib.rb_sor_slabs_full_launch.restype = ctypes.c_int
    return lib


def rb_sor_slabs_cuda(p, rhs, *, dx: float, dy: float, omega: float,
                      nslabs: int, inner_iters: int):
    """One launch of ``csrc/poisson_sor_full.cu``: grid (nslabs, n_env)."""
    dev = p.device
    if dev.type != "cuda":
        raise ValueError(f"rb_sor_slabs_cuda needs CUDA tensors, got {dev}; "
                         f"CPU tensors take the plain twin")
    ny, nx = p.shape[-2:]
    bx = _check_full_slabs(nx, nslabs)
    smem = full_smem_bytes(ny, bx)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"a ({ny}, {bx}) slab needs {smem} bytes of shared "
                         f"memory, over the {SMEM_PER_BLOCK}-byte limit of "
                         f"one block; use more slabs")
    for name, t in (("p", p), ("rhs", rhs)):
        if t.shape != p.shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"{name}: expected float32 {tuple(p.shape)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    lead = p.shape[:-2]
    pf = p.reshape(-1, ny, nx).contiguous()
    rf = rhs.reshape(-1, ny, nx).contiguous()
    out = torch.empty_like(pf)
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    lib = _load_full()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rb_sor_slabs_full_launch(
            pf.data_ptr(), rf.data_ptr(), out.data_ptr(), pf.shape[0], ny, nx,
            nslabs, inner_iters, smem, dx2, dy2, inv_diag, omega, 1.0 - omega,
            stream)
    from repro_torch.kernels.build import check_launch
    check_launch(lib, err, "rb_sor_slabs")
    rb_sor_slabs_cuda.launches += 1
    return out.reshape(*lead, ny, nx)


rb_sor_slabs_cuda.launches = 0


def rb_sor_slabs(p, rhs, *, dx: float, dy: float, omega: float, nslabs: int,
                 inner_iters: int):
    """One outer block-Jacobi round on the full grid, all slabs in
    parallel: the kernel on CUDA tensors, the plain twin on CPU tensors."""
    kw = dict(dx=float(dx), dy=float(dy), omega=float(omega), nslabs=nslabs,
              inner_iters=inner_iters)
    if p.device.type == "cuda":
        return rb_sor_slabs_cuda(p, rhs, **kw)
    return rb_sor_slabs_plain(p, rhs, **kw)


def rb_sor(rhs, dx, dy, *, iters: int = 60, omega: float = 1.7, p0=None,
           nslabs: int = 0, inner_iters: int = 4, packed: bool = True):
    """Drop-in pressure solve on ``(..., ny, nx)`` built from the slab
    smoothers: ``ceil(iters / inner_iters)`` block-Jacobi rounds of
    ``inner_iters`` sweep pairs and no polish.  ``packed=True`` runs the
    packed smoother on the checkerboard planes, ``packed=False`` the
    full-grid masked one.  Raises ``ValueError`` on an odd width."""
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
    for _ in range(-(-iters // inner_iters)):
        p = rb_sor_slabs(p, rhs, dx=dx, dy=dy, omega=omega, nslabs=nslabs,
                         inner_iters=inner_iters)
    return p
