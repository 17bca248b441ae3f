"""Parity of the port's full-grid SOR slab smoother (the plain version of
``csrc/poisson_sor_full.cu``) and of the drop-in ``rb_sor`` in both modes
with the reference's ``repro.kernels.poisson`` (Pallas in interpret mode),
and of a plain twin of the kernel's partition: a cluster of bands per
(grid, slab), each band split into packed planes as it is loaded, and
every round of a one-slab solve in one launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.poisson import kernel as jkernel
from repro.kernels.poisson import ops as jops
from repro.kernels.poisson import ref as jref
from repro_torch.cfd.grid import GridConfig
from repro_torch.cfd.poisson import packed_half_sweep, sor_coefficients
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.poisson import ops as tops
from tests._torch_parity import assert_close, max_diff

DX, DY = 22.0 / 136, 4.1 / 26
SHAPE = (26, 136)                 # 136 = 2 x 68 = 4 x 34: even slabs
# float32 SOR on unit-variance fields; XLA and PyTorch round in different
# places (fusion vs op by op), a few ulp per sweep that the smoother keeps
# bounded -> 1e-5 (the packed solve's tolerance in test_torch_poisson.py)
ATOL = 1e-5


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("nslabs", [1, 2, 4])
def test_slabs_plain_matches_reference_kernel(nslabs):
    """One block-Jacobi round of 4 sweep pairs with frozen ghosts: the plain
    version against the Pallas kernel and the reference's own oracle."""
    p, rhs = _rand(SHAPE, 1), _rand(SHAPE, 2)
    kw = dict(dx=DX, dy=DY, omega=1.7, nslabs=nslabs, inner_iters=4)
    ref = jkernel.rb_sor_slabs(jnp.asarray(p), jnp.asarray(rhs),
                               interpret=True, **kw)
    oracle = jref.rb_sor_slabs_ref(jnp.asarray(p), jnp.asarray(rhs), **kw)
    out = tops.rb_sor_slabs_plain(torch.tensor(p), torch.tensor(rhs), **kw)
    assert_close(ref, out, ATOL, f"nslabs {nslabs} vs kernel")
    assert_close(oracle, out, ATOL, f"nslabs {nslabs} vs oracle")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("nslabs", [0, 2, 4])
def test_rb_sor_matches_reference(packed, nslabs):
    """The drop-in solve, ceil(30 / 4) = 8 rounds, from a warm start."""
    rhs, p0 = _rand(SHAPE, 3), 0.1 * _rand(SHAPE, 4)
    kw = dict(iters=30, omega=1.7, nslabs=nslabs, inner_iters=4,
              packed=packed)
    ref = jops.rb_sor(jnp.asarray(rhs), DX, DY, p0=jnp.asarray(p0), **kw)
    out = tops.rb_sor(torch.tensor(rhs), DX, DY, p0=torch.tensor(p0), **kw)
    assert_close(ref, out, ATOL, f"packed={packed} nslabs={nslabs}")


def test_rb_sor_cold_start_and_rounds():
    """p0=None starts from zeros; iters=0 runs no round; rounds are
    ceil(iters / inner_iters), so iters 5 and 8 agree at inner_iters 4."""
    rhs = _rand(SHAPE, 5)
    ref = jops.rb_sor(jnp.asarray(rhs), DX, DY, iters=12, packed=False)
    out = tops.rb_sor(torch.tensor(rhs), DX, DY, iters=12, packed=False)
    assert_close(ref, out, ATOL, "cold start")
    zero = tops.rb_sor(torch.tensor(rhs), DX, DY, iters=0, packed=False)
    assert not zero.any()
    a = tops.rb_sor(torch.tensor(rhs), DX, DY, iters=5, packed=False)
    b = tops.rb_sor(torch.tensor(rhs), DX, DY, iters=8, packed=False)
    assert torch.equal(a, b)


def test_rb_sor_batched_matches_per_env():
    """A leading env axis batches exactly, in both modes."""
    rhs = _rand((3,) + SHAPE, 6)
    for packed in (False, True):
        batched = tops.rb_sor(torch.tensor(rhs), DX, DY, iters=8,
                              nslabs=2, packed=packed)
        for i in range(3):
            alone = tops.rb_sor(torch.tensor(rhs[i]), DX, DY, iters=8,
                                nslabs=2, packed=packed)
            assert torch.equal(alone, batched[i]), (packed, i)


def test_rb_sor_rejects_odd_width_and_bad_slabs():
    with pytest.raises(ValueError, match="even grid width"):
        tops.rb_sor(torch.zeros((6, 11)), DX, DY, packed=False)
    with pytest.raises(ValueError, match="slabs of even width"):
        tops.rb_sor_slabs(torch.zeros(SHAPE), torch.zeros(SHAPE), dx=DX,
                          dy=DY, omega=1.7, nslabs=8, inner_iters=1)


def test_cuda_entry_refuses_cpu_tensors():
    """The kernel's launcher takes CUDA tensors only; the dispatching
    wrapper sends CPU tensors to the plain version."""
    p = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.rb_sor_slabs_cuda(p, p, dx=DX, dy=DY, omega=1.7, nslabs=1,
                               inner_iters=1)
    n0 = tops.rb_sor_slabs_cuda.launches
    tops.rb_sor_slabs(p, p, dx=DX, dy=DY, omega=1.7, nslabs=1, inner_iters=1)
    assert tops.rb_sor_slabs_cuda.launches == n0


def test_smem_bytes_of_the_res16_slab():
    """At res 16 (66 x 352, one slab: _pick_nslabs gives 1) a block of a
    16-block cluster holds a band of 5 rows split into red and black (176
    packed columns each) with a halo row each side, both right-hand sides,
    four ghost columns and two mbarriers: 16,992 bytes, the packed
    kernel's for the (66, 176) planes."""
    assert tops.full_smem_bytes(66, 352, 16) == 4 * (
        4 + 2 * 7 * 176 + 2 * 5 * 176 + 4 * 5) == 16_992
    assert tops.full_smem_bytes(66, 352, 16) == tops.smem_bytes(66, 176, 16)
    assert tops._pick_nslabs(352) == 1


def test_full_grid_fits_res_18_to_70_in_16_blocks():
    """The full-grid kernel's shared memory per block is the packed
    kernel's on the split slab, so 16 blocks hold a slab of every grid from
    res 18 (which one block could not hold) to res
    70 at the reference's slab count; res 71, a (292, 1562) grid left in
    one slab, raises before any launch."""
    for res in range(18, 72):
        cfg = GridConfig(res=res)
        nslabs = tops._pick_nslabs(cfg.nx)
        bx = cfg.nx // nslabs
        at_16 = tops.full_smem_bytes(cfg.ny, bx, 16)
        if res <= 70:
            assert at_16 <= SMEM_PER_BLOCK, res
            assert tops.check_grid(cfg.ny, cfg.nx, nslabs) == bx
        else:
            assert (cfg.ny, cfg.nx, nslabs) == (292, 1562, 1)
            assert at_16 > SMEM_PER_BLOCK
            with pytest.raises(ValueError, match="shared memory"):
                tops.check_grid(cfg.ny, cfg.nx, nslabs)
    assert tops.full_smem_bytes(74, 396, 1) > SMEM_PER_BLOCK
    assert tops._fitting_clusters(74, 198) == [2, 4, 8, 16]


# ---------------------------------------------------------------------------
# the kernel's partition: bands of a cluster, rounds of one launch
# ---------------------------------------------------------------------------

def _split(rows, j0):
    """Rows of the full grid starting at global row ``j0`` -> their (red,
    black) packed planes, red[j, k] = p[j, 2k + j%2]."""
    m, nx = rows.shape
    pairs = rows.reshape(m, nx // 2, 2)
    odd = ((torch.arange(m) + j0) % 2 == 1)[:, None]
    return (torch.where(odd, pairs[..., 1], pairs[..., 0]),
            torch.where(odd, pairs[..., 0], pairs[..., 1]))


def _interleave(red, black, j0):
    """The inverse of :func:`_split`."""
    odd = ((torch.arange(red.shape[0]) + j0) % 2 == 1)[:, None, None]
    pairs = torch.where(odd, torch.stack([black, red], -1),
                        torch.stack([red, black], -1))
    return pairs.reshape(red.shape[0], -1)


def sor_full_banded(p, rhs, *, dx, dy, omega, nslabs, inner_iters, rounds,
                    cluster):
    """One launch of the full-grid kernel on a (ny, nx) grid, as a plain
    twin of its partition: per slab, ``cluster`` bands of rows, each split
    into packed planes as it is loaded (with a halo row above and below),
    swept colour by colour from its own copy of the other colour, after
    every half-sweep its edge rows of that colour copied into the
    neighbours' halo rows, and interleaved back as it is stored.  The
    ghost columns are full-width grid columns: at the first round the
    input's (the neighbour slab's edge column, the inlet column, minus the
    outlet column), at later rounds (one slab) the band's own first and
    minus last column at the round's start."""
    ny, nx = p.shape
    if rounds > 1 and nslabs != 1:
        raise ValueError("one launch runs several rounds with one slab only")
    bx = nx // nslabs
    starts = kcluster.band_starts(ny, cluster)
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    row_odd = (torch.arange(ny) % 2 == 1)[:, None]
    shift = {"r": row_odd, "b": ~row_odd}
    slabs = []
    for s in range(nslabs):
        c0, c1 = s * bx, (s + 1) * bx
        left = p[:, c0:c0 + 1] if s == 0 else p[:, c0 - 1:c0]
        right = -p[:, c1 - 1:c1] if s == nslabs - 1 else p[:, c1:c1 + 1]
        bands = []
        for j0, j1 in zip(starts, starts[1:]):
            band = {"rows": (j0, j1)}
            band["r"], band["b"] = _split(p[j0:j1, c0:c1], j0)
            band["rhs_r"], band["rhs_b"] = _split(rhs[j0:j1, c0:c1], j0)
            up = _split(p[j0 - 1:j0, c0:c1], j0 - 1) if j0 else (None, None)
            dn = _split(p[j1:j1 + 1, c0:c1], j1) if j1 < ny else (None, None)
            band["r_up"], band["b_up"] = up
            band["r_dn"], band["b_dn"] = dn
            bands.append(band)
        for rnd in range(rounds):
            ghosts = []
            for band in bands:
                j0, j1 = band["rows"]
                if rnd == 0:
                    ghosts.append((left[j0:j1], right[j0:j1]))
                else:
                    full = _interleave(band["r"], band["b"], j0)
                    ghosts.append((full[:, :1], -full[:, -1:]))
            for _ in range(inner_iters):
                for c, o in (("r", "b"), ("b", "r")):
                    for band, (lg, rg) in zip(bands, ghosts):
                        j0, j1 = band["rows"]
                        a = band[c]
                        north = band[o + "_up"] if j0 else a[:1]
                        south = band[o + "_dn"] if j1 < ny else a[-1:]
                        band[c] = packed_half_sweep(
                            a, band[o], band["rhs_" + c], lg, rg, north,
                            south, shift[c][j0:j1], omega, dx2, dy2,
                            inv_diag)
                    for i, band in enumerate(bands):
                        if i:
                            band[c + "_up"] = bands[i - 1][c][-1:]
                        if i + 1 < len(bands):
                            band[c + "_dn"] = bands[i + 1][c][:1]
        slabs.append(torch.cat([_interleave(b["r"], b["b"], b["rows"][0])
                                for b in bands]))
    return torch.cat(slabs, dim=-1)


def _banded_solve(rhs, p0, *, iters, nslabs, cluster, inner_iters=4):
    """rb_sor(packed=False) as the card runs it: all rounds in one launch
    with one slab, one launch a round with several."""
    rounds = -(-iters // inner_iters)
    launches, per_launch = (1, rounds) if nslabs == 1 else (rounds, 1)
    p = p0
    for _ in range(launches):
        p = sor_full_banded(p, rhs, dx=DX, dy=DY, omega=1.7, nslabs=nslabs,
                            inner_iters=inner_iters, rounds=per_launch,
                            cluster=cluster)
    return p


@pytest.mark.parametrize("nslabs", [1, 2])
@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_sor_full_bands_match_reference(cluster, nslabs):
    """26 rows in 1, 4 or 16 bands (16: bands of 1 and 2 rows, so a band's
    single row is both its edges), one or two slabs, ceil(30 / 4) = 8
    rounds from a warm start.  A frozen full-width ghost column gives each
    coloured half-sweep the single-parity values it reads, and red-black
    SOR reads only the other colour, so the banded, split solve gives the
    port's full-grid twin bit for bit, and the reference's
    rb_sor(packed=False) within its float32 drift (1e-5, as above)."""
    rhs, p0 = _rand(SHAPE, 3), 0.1 * _rand(SHAPE, 4)
    ref = jops.rb_sor(jnp.asarray(rhs), DX, DY, p0=jnp.asarray(p0), iters=30,
                      nslabs=nslabs, packed=False)
    plain = tops.rb_sor(torch.tensor(rhs), DX, DY, p0=torch.tensor(p0),
                        iters=30, nslabs=nslabs, packed=False)
    out = _banded_solve(torch.tensor(rhs), torch.tensor(p0), iters=30,
                        nslabs=nslabs, cluster=cluster)
    assert torch.equal(out, plain)
    assert_close(ref, out, ATOL, f"cluster {cluster} nslabs {nslabs}")


def test_sor_full_bands_snapshot_ghosts_per_round():
    """The ghosts of a round are the round's start values: one launch that
    froze them once for all 8 rounds (as a kernel that skipped the
    snapshot would) differs from the reference by far more than its
    drift."""
    rhs, p0 = _rand(SHAPE, 3), 0.1 * _rand(SHAPE, 4)
    ref = jops.rb_sor(jnp.asarray(rhs), DX, DY, p0=jnp.asarray(p0), iters=32,
                      nslabs=1, packed=False)
    frozen = sor_full_banded(torch.tensor(p0), torch.tensor(rhs), dx=DX,
                             dy=DY, omega=1.7, nslabs=1, inner_iters=32,
                             rounds=1, cluster=4)
    assert max_diff(ref, frozen)[0] > 1e-3
