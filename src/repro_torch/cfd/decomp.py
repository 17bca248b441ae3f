"""Explicit spatial domain decomposition of the Poisson solve: x-slabs and
halo messages, the paper's N_ranks axis (OpenFOAM's MPI ranks).

Port of ``repro.cfd.decomp``.  The reference runs one slab per device under
``shard_map`` and exchanges halos with ``lax.ppermute``.  Here a rank is an
x-slab, and an env's ``n_ranks`` slabs sit side by side as a rank dimension
of the same tensors on the env's device, ``(..., R, ny, bx)``.  A halo
message is an explicit tensor: the neighbour slab's edge column, gathered
by index, passed through :func:`send` (the one place every message goes,
so :func:`record_messages` can count them).  The iteration is the
reference's, sweep for sweep, and each half-sweep costs the same number of
ops whatever the rank count: one controller steps every slab at once, so
the exchange never leaves the device (a process per rank would pay a
device -> host -> device round trip per message, 12,000 of them per
actuation interval at the production settings).

Each slab is held in packed-checkerboard storage (red / black planes, see
``cfd/poisson.py``), so a colored half-sweep needs only the *opposite*
parity entries of the neighbour's edge column: every message is a
half-width single-parity column (ceil(ny/2) values) instead of a full one.

Two coupling schedules:

  ``inner_iters == 1``  exchange before EVERY colored half-sweep (two
        half-width messages per rank boundary per half-sweep).  The black
        sweep then sees fresh red values across rank boundaries, which
        makes the decomposed iteration exactly the monolithic red-black
        sweep at any rank count.
  ``inner_iters > 1``   block-Jacobi: one full-edge exchange (both
        parities, packed into one message pair) per outer round, halos
        frozen for ``inner_iters`` local sweep pairs; the last round stops
        after exactly ``iters`` pairs.

Grids whose slab width or height is odd fall back to the legacy full-grid
sweeps (``packed=False`` forces that path; it exchanges full edge columns
once per outer round, frozen for ``inner_iters`` pairs).  The domain-edge
ghosts (Neumann at the inlet slab, Dirichlet at the outlet slab) are
recomputed from the live local planes every sweep, as in the monolithic
solve.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Optional, Tuple

import torch

from repro_torch.cfd import poisson
from repro_torch.launch import cost_analysis


def validate_decomposition(mesh, nx: int, axis: str = "model") -> int:
    """Number of x-slabs for ``mesh``/``axis``, with actionable errors.

    Raises ``ValueError`` when the axis is missing from the mesh or the
    grid width does not divide into equal slabs."""
    axes = tuple(mesh.shape.keys()) if hasattr(mesh.shape, "keys") \
        else tuple(mesh.axis_names)
    if axis not in axes:
        raise ValueError(
            f"mesh has no {axis!r} axis (axes: {axes}); build it with a "
            f"spatial axis — e.g. launch.mesh.mesh_for_plan(plan) or "
            f"make_debug_mesh(n_data, n_model) — or pass axis=<name>")
    n_shards = mesh.shape[axis]
    if nx % n_shards:
        lo, hi = nx - nx % n_shards, nx + (-nx) % n_shards
        raise ValueError(
            f"grid width nx={nx} does not split into {n_shards} equal "
            f"x-slabs over mesh axis {axis!r}; use a grid with "
            f"nx % n_ranks == 0 (e.g. nx={lo} or nx={hi}) or a plan whose "
            f"n_ranks divides {nx}")
    return n_shards


def halo_exchange_values(ny: int, packed: bool = True) -> int:
    """Scalars shipped per message: a full edge column for the legacy path,
    a single-parity half column for the packed path."""
    return -(-ny // 2) if packed else ny


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

# the active recorders (record_messages), innermost last
_RECORDERS: List[List[Tuple[Tuple[int, int], int]]] = []


def send(msgs: torch.Tensor) -> torch.Tensor:
    """Deliver one exchange's messages, ``(..., R - 1, h, 1)``: message k
    of a forward exchange goes from rank k to rank k + 1, of a backward
    one from rank k + 1 to rank k.  The slabs share a device, so delivery
    is the identity; every halo message of this module passes here.
    Under a cost counter (``launch/cost_analysis``) the exchange counts as
    one ``collective-permute`` of every message's bytes, the reference's
    ``lax.ppermute``."""
    for log in _RECORDERS:
        log.append((tuple(msgs.shape[-2:]), int(msgs.shape[-3])))
    cost_analysis.collective("collective-permute", msgs)
    return msgs


@contextlib.contextmanager
def record_messages() -> Iterator[List[Tuple[Tuple[int, int], int]]]:
    """Record every :func:`send` inside the block as ``(message shape,
    messages per env)``: the shape is one message's ``(h, 1)`` column,
    the count that exchange's rank boundaries.  Sum the counts for the
    messages an env sent; times ``h * 4`` bytes for its volume."""
    log: List[Tuple[Tuple[int, int], int]] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


def _forward(edge: torch.Tensor) -> torch.Tensor:
    """Rank k's edge column -> rank k + 1: what ranks 1..R-1 receive."""
    return send(edge[..., :-1, :, :])


def _backward(edge: torch.Tensor) -> torch.Tensor:
    """Rank k + 1's edge column -> rank k: what ranks 0..R-2 receive."""
    return send(edge[..., 1:, :, :])


# ---------------------------------------------------------------------------
# slabs
# ---------------------------------------------------------------------------

def to_slabs(a: torch.Tensor, n_shards: int) -> torch.Tensor:
    """(..., ny, W) -> (..., R, ny, W // R): the x-slabs of a plane."""
    *lead, ny, w = a.shape
    return a.reshape(*lead, ny, n_shards, w // n_shards).movedim(-2, -3)


def from_slabs(a: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_slabs`."""
    *lead, r, ny, bx = a.shape
    return a.movedim(-3, -2).reshape(*lead, ny, r * bx)


def _edges(own: torch.Tensor, from_left: Optional[torch.Tensor],
           from_right: Optional[torch.Tensor]):
    """Ghost columns (..., R, ny, 1) of every slab: rank 0's left ghost is
    its own first column (Neumann inlet), the last rank's right ghost its
    negated last column (Dirichlet outlet); the others are the received
    halos, already full-height (``None`` with one rank)."""
    left = own[..., :1, :, :1]
    right = -own[..., -1:, :, -1:]
    if from_left is not None:
        left = torch.cat([left, from_left], dim=-3)
        right = torch.cat([from_right, right], dim=-3)
    return left, right


def _spread(half: torch.Tensor) -> torch.Tensor:
    """Half-column ghost (ny even): received single-parity value k lands on
    rows 2k and 2k + 1, so on its own row parity whichever it is; the
    other rows are never selected by the sweep."""
    *lead, h, one = half.shape
    return half.unsqueeze(-2).expand(*lead, h, 2, one).reshape(
        *lead, 2 * h, one)


# ---------------------------------------------------------------------------
# legacy full-grid path (odd slab width / height fallback)
# ---------------------------------------------------------------------------

def _solve_full(rhs, p0, *, n_shards, dx, dy, omega, iters, inner_iters,
                polish):
    ny, nx = rhs.shape[-2:]
    bx = nx // n_shards
    outer = -(-iters // inner_iters)
    n_sor = iters - min(polish, iters // 2)
    dx2, dy2 = dx * dx, dy * dy
    inv_diag = 1.0 / (2.0 / dx2 + 2.0 / dy2)
    dev = rhs.device
    jj = torch.arange(ny, device=dev)[:, None]
    ii = torch.arange(nx, device=dev).reshape(n_shards, 1, bx)
    red = (ii + jj) % 2 == 0                                  # (R, ny, bx)
    rhs_s = to_slabs(rhs, n_shards)
    p = to_slabs(p0, n_shards)

    def sweep(p, halos, mask, om):
        left, right = _edges(p, *halos)
        pp = torch.cat([left, p, right], dim=-1)
        pp = torch.cat([pp[..., :1, :], pp, pp[..., -1:, :]], dim=-2)
        nb = ((pp[..., 1:-1, :-2] + pp[..., 1:-1, 2:]) / dx2
              + (pp[..., :-2, 1:-1] + pp[..., 2:, 1:-1]) / dy2)
        p_gs = (nb - rhs_s) * inv_diag
        return torch.where(mask, (1 - om) * p + om * p_gs, p)

    for i in range(outer):
        # my rightmost column -> right neighbour's left halo, my leftmost ->
        # left neighbour's right halo: two messages per rank boundary
        halos = ((_forward(p[..., -1:]), _backward(p[..., :1]))
                 if n_shards > 1 else (None, None))
        for j in range(min(inner_iters, iters - i * inner_iters)):
            om = omega if i * inner_iters + j < n_sor else 1.0
            p = sweep(p, halos, red, om)
            p = sweep(p, halos, ~red, om)
    return from_slabs(p)


# ---------------------------------------------------------------------------
# packed-checkerboard path (the default)
# ---------------------------------------------------------------------------

def _solve_packed(rhs, p0, *, n_shards, dx, dy, omega, iters, inner_iters,
                  polish):
    ny = rhs.shape[-2]
    n_sor = iters - min(polish, iters // 2)
    dx2, dy2, inv_diag = poisson.sor_coefficients(dx, dy)
    multi = n_shards > 1
    # the slab width is even, so every slab starts on an even global column
    # and the local packing parity is the global one: pack, then split
    red, black = (to_slabs(a, n_shards) for a in poisson.pack_checkerboard(p0))
    rhs_r, rhs_b = (to_slabs(a, n_shards)
                    for a in poisson.pack_checkerboard(rhs))
    row_odd = (torch.arange(ny, device=rhs.device) % 2 == 1)[:, None]

    def red_half(red, black, halos, om):
        return poisson.packed_half_sweep(
            red, black, rhs_r, *_edges(red, *halos),
            *poisson.packed_ghost_rows(red, black),
            row_odd, om, dx2, dy2, inv_diag)

    def black_half(red, black, halos, om):
        return poisson.packed_half_sweep(
            black, red, rhs_b, *_edges(black, *halos),
            *poisson.packed_ghost_rows(black, red),
            ~row_odd, om, dx2, dy2, inv_diag)

    def exchange(to_right, to_left):
        """One half-sweep's halos: every slab's right-edge half column
        to its right neighbour, its left-edge one to its left neighbour,
        each spread over its rows on arrival (None with one rank)."""
        if not multi:
            return None, None
        return _spread(_forward(to_right)), _spread(_backward(to_left))

    if inner_iters == 1:
        # tight coupling: a half-width exchange before every half-sweep —
        # the decomposed iteration IS the monolithic red-black sweep
        for i in range(iters):
            om = omega if i < n_sor else 1.0
            # red updates sit on even rows of even columns / odd rows of odd
            # columns, so their west/east ghosts are the neighbour's BLACK
            # edge entries: even rows from the left, odd from the right (and
            # mirrored parities for the black update)
            red = red_half(red, black, exchange(black[..., 0::2, -1:],
                                                black[..., 1::2, :1]), om)
            black = black_half(red, black, exchange(red[..., 1::2, -1:],
                                                    red[..., 0::2, :1]), om)
    else:
        # block-Jacobi: both parities of the edge columns cross once per
        # outer round (one packed message pair), then stay frozen
        h = ny // 2
        for i in range(-(-iters // inner_iters)):
            if multi:
                from_left = _forward(torch.cat(
                    [black[..., 0::2, -1:], red[..., 1::2, -1:]], dim=-2))
                from_right = _backward(torch.cat(
                    [black[..., 1::2, :1], red[..., 0::2, :1]], dim=-2))
                red_halos = (_spread(from_left[..., :h, :]),
                             _spread(from_right[..., :h, :]))
                black_halos = (_spread(from_left[..., h:, :]),
                               _spread(from_right[..., h:, :]))
            else:
                red_halos = black_halos = (None, None)
            for j in range(min(inner_iters, iters - i * inner_iters)):
                om = omega if i * inner_iters + j < n_sor else 1.0
                red = red_half(red, black, red_halos, om)
                black = black_half(red, black, black_halos, om)
    return poisson.unpack_checkerboard(from_slabs(red), from_slabs(black))


def decomposed_solve(rhs, p0=None, *, mesh, axis: str = "model",
                     dx: float, dy: float, omega: float = 1.7,
                     iters: int = 60, inner_iters: int = 4,
                     polish: int = 10, packed: Optional[bool] = None):
    """x-slab + halo-exchange pressure solve of ``(..., ny, nx)`` planes,
    ``mesh.shape[axis]`` slabs per env.

    Exactly ``iters`` red-black sweep pairs run (the reference solver's
    work at equal ``iters``); the last ``polish`` pairs run with omega = 1,
    as in ``poisson.solve``.  Sweeps run in packed-checkerboard storage
    with half-width single-parity halos whenever the slab width and height
    are even (``packed=None`` auto; ``packed=False`` forces the legacy
    full-grid frozen-halo path).  See the module docstring for the two
    ``inner_iters`` coupling schedules."""
    n_shards = validate_decomposition(mesh, rhs.shape[-1], axis)
    ny = rhs.shape[-2]
    bx = rhs.shape[-1] // n_shards
    if packed is None:
        packed = bx % 2 == 0 and ny % 2 == 0
    elif packed and (bx % 2 or ny % 2):
        raise ValueError(
            f"packed halo sweeps need an even slab width and height, got "
            f"bx={bx}, ny={ny} (nx={rhs.shape[-1]} over {n_shards} ranks); "
            f"pass packed=False or use an even-slab grid")
    p0 = torch.zeros_like(rhs) if p0 is None else p0
    impl = _solve_packed if packed else _solve_full
    return impl(rhs, p0, n_shards=n_shards, dx=dx, dy=dy,
                omega=float(omega), iters=iters, inner_iters=inner_iters,
                polish=polish)


def make_decomposed_poisson(mesh, nx: int, *, axis: str = "model",
                            dx: float, dy: float, omega: float = 1.7,
                            inner_iters: int = 4, polish: int = 10
                            ) -> Callable:
    """Returns a ``(rhs, p0=None, *, iters=60) -> p`` solver where the
    grid is decomposed into x-slabs over ``axis`` with explicit halo
    exchange."""
    validate_decomposition(mesh, nx, axis)

    def solve(rhs, p0=None, *, iters: int = 60):
        return decomposed_solve(rhs, p0, mesh=mesh, axis=axis, dx=dx, dy=dy,
                                omega=omega, iters=iters,
                                inner_iters=inner_iters, polish=polish)

    return solve
