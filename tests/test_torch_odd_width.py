"""The odd grid widths on the CPU: the packed layout of an odd width (planes
of ceil(nx / 2) columns, a dead slot a row), the plain twin of the
kernels' odd row rule against the reference's full-grid sweep, and the
planners' sizes and tiers on odd grids.  The kernels themselves run only on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import poisson as jp
from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import poisson as tp
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.poisson import ops as pops
from tests._torch_parity import assert_close

# the tolerance the packed sweep is held to against the reference
# (tests/test_torch_poisson.py SOLVE_ATOL)
SOLVE_ATOL = 1e-5
ODD_SHAPES = ((8, 11), (6, 13), (34, 175))
DX, DY = 22.0 / 132, 4.1 / 26
# the fake card of tests/test_torch_global_kernels.py: 132 SMs, the
# clusters of each size it holds at once, one global-memory block an SM
ACTIVE = {16: 7, 8: 15, 4: 30, 2: 66}
N_SM = 132
RESIDENT = 132


class _Odd(tgrid.GridConfig):
    """A grid one column narrower than ``GridConfig(res)``'s (an odd
    width)."""
    nx = property(lambda self: 22 * self.res - 1)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _half(nx):
    """The packed width worked out by hand: nx // 2 points of each colour
    on a row, one more of the colour at column 0 on an odd width."""
    return nx // 2 + nx % 2


@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_odd_pack_round_trip(shape):
    """The odd layout is pure data movement: each plane ceil(nx / 2)
    wide, red[j, k] = p[j, 2k + j%2], black[j, k] = p[j, 2k + 1 - j%2],
    each row's dead slot (red's on odd rows, black's on even ones) 0, and
    an exact round trip."""
    ny, nx = shape
    a = torch.tensor(_rand((3,) + shape, seed=nx))
    red, black = pops.pack_planes(a)
    w = _half(nx)
    assert red.shape == black.shape == (3, ny, w)
    for j in range(ny):
        for k in range(w):
            for plane, i in ((red, 2 * k + j % 2), (black, 2 * k + 1 - j % 2)):
                want = a[:, j, i] if i < nx else torch.zeros(3)
                assert torch.equal(plane[:, j, k], want)
    assert not red[:, 1::2, -1].any() and not black[:, 0::2, -1].any()
    assert torch.equal(pops.unpack_planes(red, black, nx), a)


@pytest.mark.parametrize("iters", [6, 60])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_odd_twin_matches_full_sweeps(shape, iters):
    """The kernels' odd row rule in plain PyTorch (``full_sweeps_plain``:
    iters pairs on the odd layout, the last n_polish at omega 1) against
    the port's full-grid sweep (``_full_sweeps``, bit for bit: the same
    arithmetic point by point) and the reference's ``solve(...,
    backend="full")`` (SOLVE_ATOL), from a warm start.  The dead slots
    stay 0 through every pair."""
    rhs, p0 = _rand(shape, 1), 0.1 * _rand(shape, 2)
    n_sor = iters - tp.n_polish(iters)
    got = pops.full_sweeps_plain(torch.tensor(p0), torch.tensor(rhs), dx=DX,
                                 dy=DY, omega=1.7, iters=iters, n_sor=n_sor)
    port = tp._full_sweeps(torch.tensor(rhs), torch.tensor(p0), DX, DY,
                           iters, n_sor, 1.7)
    assert torch.equal(got, port)
    ref = jp.solve(jnp.asarray(rhs), DX, DY, iters=iters, backend="full",
                   p0=jnp.asarray(p0))
    assert_close(ref, got, SOLVE_ATOL, f"odd twin {shape} iters {iters}")
    assert torch.equal(pops.full_sweeps(torch.tensor(rhs), torch.tensor(p0),
                                        DX, DY, iters=iters, n_sor=n_sor,
                                        omega=1.7), got)
    red, black = pops.pack_planes(torch.tensor(p0))
    rr, rb = pops.pack_planes(torch.tensor(rhs))
    for _ in range(3):
        red, black = pops.odd_sweep_pair(red, black, rr, rb, 1.7, dx=DX,
                                         dy=DY)
        assert not red[1::2, -1].any() and not black[0::2, -1].any()


def test_full_sweeps_refuse_what_they_do_not_serve():
    """The full sweeps serve odd widths only (an even one takes the slab
    kernels), and their CUDA wrapper CUDA tensors only."""
    even = torch.zeros(8, 12)
    with pytest.raises(ValueError, match="odd grid widths"):
        pops.full_sweeps(even, even, DX, DY, iters=6, n_sor=3, omega=1.7)
    odd = torch.zeros(8, 11)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pops.full_sweeps_cuda(odd, odd, dx=DX, dy=DY, omega=1.7, iters=6,
                              n_sor=3)


def _fused_smem(ny, nx, g, n_bodies):
    """One block of the fused kernels at g blocks an env, field by field:
    the largest band of u (halo rows), v (halo rows and the wall row),
    u_pen, v_pen, red, black (halo rows), rhs_r, rhs_b, then the
    mbarriers, the partial sums and the reduction's slots."""
    r, w = -(-ny // g), _half(nx)
    extra = 4 + 4 + 128 if not n_bodies else 4 + 8 + 232
    return 4 * ((r + 2) * (nx + 1) + (r + 3) * nx + r * nx + (r + 1) * nx
                + 2 * (r + 2) * w + 2 * r * w + extra)


def _env_floats(ny, nx):
    w = _half(nx)
    return ((ny + 2) * (nx + 1) + (ny + 3) * nx + ny * nx + (ny + 1) * nx
            + 2 * (ny + 2) * w + 2 * ny * w)


@pytest.mark.parametrize("n_bodies", [0, 3])
@pytest.mark.parametrize("res,tier", [(8, "cluster"), (48, "resident"),
                                      (56, "global")])
def test_fused_planner_on_odd_grids(res, tier, n_bodies):
    """The fused kernels on a grid one column narrower than res 8, 48 and
    56: shared memory, workspace and mirror slots sized on planes of
    ceil(nx / 2) columns, as worked out by hand, and the tier the sizes
    call for (the cluster kernel, the resident one at G 32, the
    global-memory one at G 32), as an even grid gets it."""
    cfg = _Odd(res=res)
    ny, nx = cfg.ny, cfg.nx
    assert nx % 2 == 1
    for g in (1, 2, 4, 8, 16, 24, 32):
        assert aops.smem_bytes(ny, nx, g, n_bodies) == _fused_smem(
            ny, nx, g, n_bodies)
    assert aops.env_floats(ny, nx) == _env_floats(ny, nx)
    slots = 8 if n_bodies else 4
    assert aops.workspace_bytes(ny, nx, 32, 4, n_bodies) == 4 * 4 * (
        _env_floats(ny, nx) + 32 * slots + 32 * 32)
    # 16 clusters of 2 an env: 15 edges, 2 directions, 11 slots of nx + 1
    # floats on 128-byte lines
    mirror = 15 * 2 * 11 * 32 * -(-(nx + 1) // 32)
    assert aops.resident_workspace_bytes(ny, nx, 32, 2, 4, n_bodies) == \
        4 * 4 * (32 * slots + 32 * 32 + mirror)
    fits = [g for g in (1, 2, 4, 8, 16)
            if _fused_smem(ny, nx, g, n_bodies) <= SMEM_PER_BLOCK]
    fits_resident = [g for g in (24, 32)
                     if _fused_smem(ny, nx, g, n_bodies) <= SMEM_PER_BLOCK]
    want = "cluster" if fits else "resident" if fits_resident else "global"
    assert want == tier
    assert aops.check_kernel_grid(cfg, n_bodies) == tier
    plan = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT,
                            n_bodies)
    assert plan.kernel == tier and plan.launches == 1
    if tier == "cluster":
        assert plan.size == 16 and plan.workspace_bytes == 0
    elif tier == "resident":
        assert (plan.size, plan.cluster) == (32, 2)
        assert plan.workspace_bytes == 4 * 4 * (32 * slots + 32 * 32
                                                + mirror)
    else:
        assert plan.size == 32
        assert plan.workspace_bytes == aops.workspace_bytes(ny, nx, 32, 4,
                                                            n_bodies)


def _slab_smem(ny, w, g):
    """One block of the full-grid kernel's full sweeps at g blocks a grid:
    red and black with a halo row each side, rhs_r and rhs_b, four ghost
    columns, two mbarriers, on planes of w columns."""
    r = -(-ny // g)
    return 4 * (4 + 2 * (r + 2) * w + 2 * r * w + 4 * r)


@pytest.mark.parametrize("grid,tier", [((8, 11), "cluster"),
                                       (71, "resident"), (95, "global")])
def test_full_sweeps_planner_on_odd_grids(grid, tier):
    """The full sweeps of an odd width on (8, 11) and on res 71 and 95 one
    column narrower: one slab of ceil(nx / 2) packed columns, its shared
    memory and workspace as worked out by hand, and the tier they call
    for, as the even grids' slabs of the same packed width get it."""
    if isinstance(grid, tuple):
        ny, nx = grid
    else:
        cfg = _Odd(res=grid)
        ny, nx = cfg.ny, cfg.nx
    w = _half(nx)
    for g in (1, 2, 4, 8, 16, 24, 32):
        if g <= ny:
            assert pops.smem_bytes(ny, w, g) == _slab_smem(ny, w, g)
    assert pops.slab_kernel(ny, w) == tier
    plan = pops.plan_launch(ny, w, 1, 4, N_SM, ACTIVE.get,
                            lambda g: RESIDENT)
    assert plan.kernel == tier and plan.launches == 1
    if tier == "cluster":
        assert plan.size == 8 and plan.workspace_bytes == 0
    elif tier == "resident":
        # 3 clusters of 8 a grid: 2 edges, 2 directions, red and black by
        # parity as tagged rows of w words, 2 slots each, on 128-byte lines
        assert (plan.size, plan.cluster) == (24, 8)
        assert plan.workspace_bytes == 4 * 4 * (2 * 2 * 8 * 32
                                                * -(-w // 32))
    else:
        assert plan.size == 32
        assert plan.workspace_bytes == 4 * 4 * (
            2 * (ny + 2) * w + 2 * ny * w + 4 * ny + 32 * 32)
