"""What surrounds the fused-interval kernel's cluster launch, on the CPU:
the band partition of one env over a thread-block cluster, the choice of
the cluster size, the per-block shared memory and block shape, and the
kernel's float32 constants.  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""
import ctypes

import numpy as np
import pytest

from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import poisson as tpoisson
from repro_torch.kernels.actuation import ops

# clusters of each size the card holds at once at res 16, as passed to
# choose_cluster: an H100 80GB HBM3 reports 7, 15 and 30 for 16, 8 and 4
# blocks of 960 threads (the blocks of a cluster share one GPC); 2 blocks
# an env hold res 8 only, 66 is assumed there
ACTIVE = {16: 7, 8: 15, 4: 30, 2: 66}
N_SM = 132


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("ny", [34, 66, 74, 132])
def test_band_partition_gives_every_row_one_rank(ny, cluster):
    """Every pressure / u row belongs to exactly one rank, in rank order;
    bands differ by at most one row.  (v takes the same bands and the
    kernel adds the top wall row ny to the last rank's; the card tests,
    which compare every v row with the twin's at each cluster size, hold
    that.)"""
    starts = ops.band_starts(ny, cluster)
    assert len(starts) == cluster + 1
    assert starts[0] == 0 and starts[-1] == ny
    sizes = [b - a for a, b in zip(starts, starts[1:])]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert ops.rows_max(starts) == max(sizes)
    p_owner = [r for r in range(cluster)
               for _ in range(starts[r], starts[r + 1])]
    assert p_owner == sorted(p_owner) and len(p_owner) == ny


def test_band_partition_rejects_more_ranks_than_rows():
    with pytest.raises(ValueError, match="cannot split"):
        ops.band_starts(8, 16)
    with pytest.raises(ValueError, match="cannot split"):
        ops.band_starts(8, 0)


# (res, envs, occupancy, expected size): the training shape spreads each
# env over 16 SMs, 8 and 16 envs stay resident at 8 and 4 blocks each; a
# batch no size keeps resident (32 envs at res 16: 30 clusters of 4 at
# most) takes the smallest size that fits (res 16: 4, res 8: 1); res 32
# fits 16 blocks only; a size over the SM count is not taken, even where
# the card would hold that many clusters two blocks to an SM
CHOICES = [(16, 4, ACTIVE, 16), (16, 8, ACTIVE, 8), (16, 16, ACTIVE, 4),
           (16, 30, ACTIVE, 4), (16, 32, ACTIVE, 4), (16, 200, ACTIVE, 4),
           (16, 4, {16: 3, 8: 15, 4: 30, 2: 66}, 8), (8, 60, ACTIVE, 2),
           (8, 200, ACTIVE, 1), (8, 7, ACTIVE, 16), (32, 32, ACTIVE, 16),
           (18, 15, ACTIVE, 8), (16, 9, {16: 9, 8: 15, 4: 30, 2: 66}, 8)]


@pytest.mark.parametrize("res,n_env,active,want", CHOICES)
def test_choose_cluster(res, n_env, active, want):
    cfg = tgrid.GridConfig(res=res)
    got = ops.choose_cluster(cfg.ny, cfg.nx, n_env, N_SM, active,
                             ops.SMEM_PER_BLOCK)
    assert got == want
    assert ops.smem_bytes(cfg.ny, cfg.nx, got) <= ops.SMEM_PER_BLOCK


def test_choose_cluster_refuses_a_grid_no_cluster_holds():
    cfg = tgrid.GridConfig(res=48)
    with pytest.raises(ValueError, match="no cluster"):
        ops.choose_cluster(cfg.ny, cfg.nx, 1, N_SM, ACTIVE,
                           ops.SMEM_PER_BLOCK)


@pytest.mark.parametrize("res", [8, 16, 18, 32])
def test_smem_bytes_per_block(res):
    """The per-block bytes follow the largest band: they shrink as the
    cluster grows, and a band of R rows takes u (R+2 rows), v (R+3), u_pen
    (R), v_pen (R+1) and four packed planes (2 x (R+2) + 2 x R rows)."""
    cfg = tgrid.GridConfig(res=res)
    ny, nx, w = cfg.ny, cfg.nx, cfg.nx // 2
    sizes = [ops.smem_bytes(ny, nx, c) for c in ops.CLUSTER_SIZES]
    assert sizes == sorted(sizes, reverse=True)
    for c, got in zip(ops.CLUSTER_SIZES, sizes):
        r = -(-ny // c)
        assert got == 4 * ((r + 2) * (nx + 1) + (r + 3) * nx + r * nx
                           + (r + 1) * nx + 2 * (r + 2) * w + 2 * r * w
                           + 136)


@pytest.mark.parametrize("res,cluster,want", [(16, 16, (960, 192)),
                                              (16, 4, (960, 192)),
                                              (8, 16, (288, 96)),
                                              (32, 16, (704, 352))])
def test_block_shape(res, cluster, want):
    """Lanes span a packed row (a multiple of 32 at least w wide), thread
    rows step over the band, at most 1024 threads."""
    cfg = tgrid.GridConfig(res=res)
    rows = ops.rows_max(ops.band_starts(cfg.ny, cluster))
    threads, tx = ops.block_shape(cfg.nx // 2, rows)
    assert (threads, tx) == want
    assert tx % 32 == 0 and tx >= cfg.nx // 2 and threads <= 1024
    assert threads % tx == 0 and threads // tx <= rows


def test_kernel_constants_are_rounded_once_from_float64():
    """Each constant, the reciprocals included, is the float64 value
    rounded once to float32 (the kernel multiplies by 1/dx, 1/dx^2, ...
    in place of dividing by dx, dx^2, ...)."""
    cfg = tgrid.GridConfig(res=16)
    got = np.array(list(ops._consts(cfg)), dtype=np.float32)
    dx, dy, dt = cfg.dx, cfg.dy, cfg.dt
    want = np.array([dt, dx, dy, 1 / dx, 1 / dy, 1 / dx ** 2, 1 / dy ** 2,
                     1 / (2 * dx), 1 / (2 * dy), 1 / dt, cfg.upwind_blend,
                     1 - cfg.upwind_blend, dt / cfg.penal_eta,
                     tpoisson.sor_coefficients(dx, dy)[2],
                     cfg.poisson_omega, 1 - cfg.poisson_omega, cfg.ny * dy,
                     0.5 * cfg.u_mean ** 2], dtype=np.float64)
    assert len(ops._consts(cfg)) == 18
    assert isinstance(ops._consts(cfg), ctypes.Array)
    np.testing.assert_array_equal(got, want.astype(np.float32))
