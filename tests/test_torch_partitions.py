"""The partitions of the packed-SOR and WKV6 kernels, on the CPU.

Each kernel spreads one problem over several blocks, and the split must
change no arithmetic:

* the packed-SOR kernel (``csrc/poisson_sor.cu``) gives each (env, slab) a
  cluster of C blocks, each holding a band of rows with a halo row above
  and below, refreshed after every half-sweep, and runs several
  block-Jacobi rounds in one launch with the ghost columns snapshot at each
  round's start;
* the WKV6 kernel (``csrc/wkv6.cu``) gives each group of value columns of
  a head's state a block of its own.

Here plain twins of those partitions are held against the port's plain
twins and against the reference's Pallas kernels in interpret mode.  The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.poisson import kernel as jsor
from repro.kernels.rwkv6 import kernel as jwkv
from repro_torch.cfd.grid import GridConfig
from repro_torch.cfd.poisson import packed_half_sweep, sor_coefficients
from repro_torch.kernels import SMEM_PER_BLOCK
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.poisson import ops as tsor
from repro_torch.kernels.rwkv6 import ops as twkv
from tests._torch_parity import assert_close, max_diff

DX, DY = 22.0 / 132, 4.1 / 26          # the res-6 grid spacing
N_SM = 132


def _rand(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# packed SOR: bands of a cluster, rounds of one launch
# ---------------------------------------------------------------------------

def sor_banded(red, black, rhs_r, rhs_b, *, dx, dy, omega, nslabs,
               inner_iters, rounds, cluster):
    """The packed-SOR kernel's partition on (ny, w) planes: per round, the
    ghost columns frozen from the round's input (the other slabs' edge
    columns, or the domain-end BCs); per slab, ``cluster`` bands of rows,
    each sweeping its own rows from its own copy of the other colour with
    a halo row above and below, and after every half-sweep each band's
    edge rows of that colour copied into its neighbours' halo rows."""
    ny, w = red.shape
    bxp = w // nslabs
    starts = kcluster.band_starts(ny, cluster)
    dx2, dy2, inv_diag = sor_coefficients(dx, dy)
    row_odd = (torch.arange(ny) % 2 == 1)[:, None]
    shift = {"r": row_odd, "b": ~row_odd}
    for _ in range(rounds):
        slabs = []
        for s in range(nslabs):
            lo, hi = s * bxp, (s + 1) * bxp
            ghost = {
                "r": (red[:, lo:lo + 1] if s == 0 else black[:, lo - 1:lo],
                      -red[:, hi - 1:hi] if s == nslabs - 1
                      else black[:, hi:hi + 1]),
                "b": (black[:, lo:lo + 1] if s == 0 else red[:, lo - 1:lo],
                      -black[:, hi - 1:hi] if s == nslabs - 1
                      else red[:, hi:hi + 1])}
            bands = []
            for j0, j1 in zip(starts, starts[1:]):
                band = {"r": red[j0:j1, lo:hi], "b": black[j0:j1, lo:hi],
                        "rhs_r": rhs_r[j0:j1, lo:hi],
                        "rhs_b": rhs_b[j0:j1, lo:hi], "rows": (j0, j1)}
                for c, plane in (("r", red), ("b", black)):
                    band[c + "_up"] = plane[j0 - 1:j0, lo:hi] if j0 else None
                    band[c + "_dn"] = plane[j1:j1 + 1, lo:hi] \
                        if j1 < ny else None
                bands.append(band)
            for _ in range(inner_iters):
                for c, o in (("r", "b"), ("b", "r")):
                    for band in bands:
                        j0, j1 = band["rows"]
                        a = band[c]
                        north = band[o + "_up"] if j0 else a[:1]
                        south = band[o + "_dn"] if j1 < ny else a[-1:]
                        lg, rg = ghost[c]
                        band[c] = packed_half_sweep(
                            a, band[o], band["rhs_" + c], lg[j0:j1],
                            rg[j0:j1], north, south, shift[c][j0:j1], omega,
                            dx2, dy2, inv_diag)
                    for i, band in enumerate(bands):
                        if i:
                            band[c + "_up"] = bands[i - 1][c][-1:]
                        if i + 1 < len(bands):
                            band[c + "_dn"] = bands[i + 1][c][:1]
            slabs.append((torch.cat([b["r"] for b in bands]),
                          torch.cat([b["b"] for b in bands])))
        red = torch.cat([r for r, _ in slabs], dim=-1)
        black = torch.cat([b for _, b in slabs], dim=-1)
    return red, black


SOR_PLANES = [_rand((26, 68), s) for s in range(4)]


@functools.lru_cache(maxsize=None)
def _sor_references(nslabs, rounds):
    """(the reference's Pallas kernel, interpret mode, and the port's plain
    twin), each chained over ``rounds`` rounds of 2 pairs."""
    kw = dict(dx=DX, dy=DY, omega=1.7, nslabs=nslabs, inner_iters=2)
    jr, jb = map(jnp.asarray, SOR_PLANES[:2])
    tr, tb = map(torch.tensor, SOR_PLANES[:2])
    for _ in range(rounds):
        jr, jb = jsor.rb_sor_slabs_packed(
            jr, jb, *map(jnp.asarray, SOR_PLANES[2:]), interpret=True, **kw)
        tr, tb = tsor.rb_sor_slabs_packed_plain(
            tr, tb, *map(torch.tensor, SOR_PLANES[2:]), **kw)
    return (jr, jb), (tr, tb)


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("nslabs", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4, 16])
def test_sor_bands_match_plain_twin_and_pallas_kernel(cluster, nslabs,
                                                      rounds):
    """26 rows in C bands (16 bands: rows of 1 and 2, so a band's single
    row is both its edges), one or two slabs, one or three rounds of 2
    pairs.  Red-black SOR reads only the other colour, so the bands give
    the plain twin's values bit for bit; the reference kernel within its
    float32 drift (a few ulp per pair, 1e-5 on unit-variance planes)."""
    (jr, jb), (tr, tb) = _sor_references(nslabs, rounds)
    br, bb = sor_banded(*map(torch.tensor, SOR_PLANES), dx=DX, dy=DY,
                        omega=1.7, nslabs=nslabs, inner_iters=2,
                        rounds=rounds, cluster=cluster)
    assert torch.equal(br, tr) and torch.equal(bb, tb)
    assert_close(jr, br, 1e-5, "red vs pallas")
    assert_close(jb, bb, 1e-5, "black vs pallas")


def test_sor_bands_snapshot_ghosts_per_round():
    """The ghosts of a round are the round's start values: a twin that
    froze them once for the whole solve (as a kernel that skipped the
    snapshot would) differs from the chained rounds by far more than the
    reference's drift."""
    planes = list(map(torch.tensor, SOR_PLANES))
    right = sor_banded(*planes, dx=DX, dy=DY, omega=1.7, nslabs=1,
                       inner_iters=6, rounds=1, cluster=4)
    chained = sor_banded(*planes, dx=DX, dy=DY, omega=1.7, nslabs=1,
                         inner_iters=2, rounds=3, cluster=4)
    assert max_diff(right[0], chained[0])[0] > 1e-3


def test_sor_cluster_choice_and_budget():
    """The packed-SOR kernel's shared memory per block (the largest band of
    red and black with halo rows, of both right-hand sides, four ghost
    columns and two mbarriers) and the cluster the shared choice gives: 16
    blocks an env at the training shape (res 16, 4 envs, one slab), fewer
    as the batch grows, down to one block an env (which fits at res 16)
    when no size keeps every env resident; res 18, over one block's
    232,448 bytes, fits 2 blocks and more.  The occupancy is the one
    test_torch_cluster.py feeds the fused kernel's choice."""
    res16, res18 = GridConfig(res=16), GridConfig(res=18)
    assert tsor.smem_bytes(66, 176, 16) == 4 * (4 + 2 * 7 * 176
                                                + 2 * 5 * 176 + 4 * 5)
    assert tsor.smem_bytes(74, 198, 1) > SMEM_PER_BLOCK
    assert tsor._fitting_clusters(74, 198) == [2, 4, 8, 16]
    active = {16: 7, 8: 15, 4: 30, 2: 66}
    for cfg, n_env, want in ((res16, 4, 16), (res16, 8, 8), (res16, 32, 2),
                             (res16, 200, 1), (res18, 4, 16),
                             (res18, 200, 2)):
        w = cfg.nx // 2
        got = tsor.choose_cluster(cfg.ny, w, n_env, N_SM, active)
        assert got == want, (cfg.res, n_env)
        assert tsor.smem_bytes(cfg.ny, w, got) <= SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# WKV6: the state split by value columns
# ---------------------------------------------------------------------------

def wkv6_column_groups(r, k, v, w, u, s0, *, chunk, mb, mm=torch.matmul):
    """The chunked algebra of the reference kernel in its (BH, S, N)
    layout, one group of ``mb`` value columns at a time: every term of
    out[:, m] and of S[:, m] reads column m of S and of v only.  The
    chunk's own output y = A v + sum(r u k) v is formed apart from r~ S, as
    the kernel's chunk pass forms it.  float32 throughout, u (BH, 1, N);
    ``mm`` computes the four products."""
    BH, S, N = r.shape
    r, k, v, w, u = (torch.as_tensor(a).float() for a in (r, k, v, w, u))
    out = torch.zeros(BH, S, N)
    s_fin = torch.zeros(BH, N, N)
    strict = torch.ones(chunk, chunk).tril(-1)
    for m0 in range(0, N, mb):
        cols = slice(m0, m0 + mb)
        st = torch.as_tensor(s0)[:, :, cols].float()
        for c0 in range(0, S, chunk):
            t = slice(c0, c0 + chunk)
            rc, kc, vc = r[:, t], k[:, t], v[:, t, cols]
            lw = torch.log(torch.clamp(w[:, t], min=1e-30))
            lp = torch.cumsum(lw, dim=1)
            rt = rc * torch.exp(lp - lw)
            kt = kc * torch.exp(-lp)
            a = mm(rt, kt.transpose(1, 2)) * strict
            dg = (rc * u * kc).sum(-1, keepdim=True)
            out[:, t, cols] = mm(rt, st) + (mm(a, vc) + dg * vc)
            st = torch.exp(lp[:, -1])[:, :, None] * (
                st + mm(kt.transpose(1, 2), vc))
        s_fin[:, :, cols] = st
    return out, s_fin


def _decay(shape, seed):
    """Decays as the RWKV-6 layer makes them: exp(-exp(w0 + d)) with the
    configs' w0 = -6 and a data term d ~ N(0, 0.5)."""
    d = np.random.default_rng(seed).standard_normal(shape)
    return np.exp(-np.exp(-6.0 + 0.5 * d)).astype(np.float32)


@pytest.mark.parametrize("mb", [8, 16, 32])
@pytest.mark.parametrize("S,chunk", [(64, 32), (100, 25)])
def test_wkv6_column_groups_match_pallas_kernel(mb, S, chunk):
    """Three heads of N = 32, in groups of 8, 16 and 32 (= N) columns,
    chunks of 32 and of 25 (the kernel pads those to 32): against the
    reference's chunked Pallas kernel (interpret mode), the same algebra in
    another summation order, 1e-5 relative to the largest |out| and |S|;
    and against the sequential twin (the kernel's oracle on the card)."""
    BH, N = 3, 32
    r, k, v = (_rand((BH, S, N), 10 + i) for i in range(3))
    w = _decay((BH, S, N), 13)
    u = _rand((BH, 1, N), 14, 0.1)
    s0 = _rand((BH, N, N), 15, 0.1)
    ref, s_ref = jwkv.wkv6_bhsn(*map(jnp.asarray, (r, k, v, w, u, s0)),
                                chunk=chunk, interpret=True)
    out, s_out = wkv6_column_groups(r, k, v, w, u, s0, chunk=chunk, mb=mb)
    scale = float(np.abs(np.asarray(ref)).max())
    s_scale = float(np.abs(np.asarray(s_ref)).max())
    assert max_diff(ref, out)[0] <= 1e-5 * scale
    assert max_diff(s_ref, s_out)[0] <= 1e-5 * s_scale
    seq, s_seq = twkv.wkv6_ref(*map(torch.tensor, (r, k, v, w, u, s0)))
    assert max_diff(seq, out)[0] <= 1e-5 * scale
    assert max_diff(s_seq, s_out)[0] <= 1e-5 * s_scale


@pytest.mark.parametrize("B,H,N,want", [(1, 40, 64, 160), (2, 2, 64, 16),
                                        (1, 8, 32, 16), (1, 1, 16, 1),
                                        (1, 3, 48, 9), (1, 2, 192, 24)])
def test_wkv6_grid_splits_each_head_by_columns(B, H, N, want):
    """One block per (batch, head, 16 value columns): rwkv6-3b at batch 1
    (40 heads of 64) gets 160 blocks, more than the card's 132 SMs and 4x
    the one-block-per-head grid.  Every multiple of 16 up to 192 is a head
    size the kernel is built for."""
    assert twkv.grid_blocks(B, H, N) == want
    assert N in twkv.HEAD_SIZES and N % twkv.COLUMNS_PER_BLOCK == 0
    assert twkv.HEAD_SIZES == tuple(range(16, 193, 16))


def test_wkv6_scratch_holds_a_stage_per_chunk():
    """The chunk pass hands the state pass, per (batch, head, chunk), r~
    in rows of N + 4, y and k~^T v for every value column and the decay,
    in float32: 33,536 bytes a chunk at rwkv6-3b's N 64, ~172 MB for its
    5120 chunks at batch 1, S = 4096."""
    per_chunk = 32 * 68 + 32 * 64 + 64 * 64 + 64
    assert twkv.scratch_floats(1, 32, 1, 64, 32) == per_chunk
    assert 4 * per_chunk == 33_536
    assert twkv.scratch_floats(1, 4096, 40, 64, 32) == 5120 * per_chunk
    assert twkv.scratch_floats(2, 100, 3, 32, 25) == 2 * 3 * 4 * (
        32 * 36 + 32 * 32 + 32 * 32 + 32)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    """a b as the kernel's tensor-core products form it: x = hi + lo, both
    TF32, and a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_wkv6_3xtf32_split_keeps_the_state_limit():
    """Why the kernel's products take the 3xTF32 split: on rwkv6-3b's head
    (N 64, chunks of 32), bf16 inputs and the layer's decays, 512 tokens,
    the chunked algebra with every product in 3xTF32 keeps the state within
    TOL_WKV_STATE (2e-5 of its largest value) of the sequential float32
    recurrence and the bf16 output within one rounding step (TOL_WKV_OUT,
    2^-7); with single-pass TF32 products the state misses the limit by
    about 10x (TF32 keeps 2^-11 of each operand)."""
    BH, S, N = 2, 512, 64
    rng = np.random.default_rng(5)

    def bf16(a):
        return torch.tensor(a, dtype=torch.float32).bfloat16().float()

    r, k, v = (bf16(rng.standard_normal((BH, S, N))) for _ in range(3))
    w = bf16(np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((BH, S, N)))))
    u = bf16(0.1 * rng.standard_normal((BH, 1, N)))
    s0 = torch.zeros(BH, N, N)
    seq, s_seq = twkv.wkv6_ref(r, k, v, w, u, s0)
    s_scale = float(s_seq.abs().max())
    out, s_out = wkv6_column_groups(r, k, v, w, u, s0, chunk=32, mb=16,
                                    mm=_mm_3xtf32)
    assert max_diff(s_seq, s_out)[0] <= 2e-5 * s_scale
    assert max_diff(seq.bfloat16().float(), out.bfloat16().float())[0] \
        <= 2 ** -7 * float(seq.abs().max())
    _, s_one = wkv6_column_groups(r, k, v, w, u, s0, chunk=32, mb=16,
                                  mm=_mm_tf32)
    assert max_diff(s_seq, s_one)[0] > 2e-5 * s_scale
