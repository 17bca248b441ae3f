"""Parity of the port's Poisson layer (repro_torch.cfd.poisson and the
packed-SOR slab kernel's plain twin) with the reference (repro, JAX)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import poisson as jp
from repro.kernels.poisson import kernel as jkernel
from repro.kernels.poisson import ops as jops
from repro.kernels.poisson import ref as jref
from repro_torch.cfd import poisson as tp
from repro_torch.kernels.poisson import ops as tops
from tests._torch_parity import assert_close, to_np

DX, DY = 22.0 / 132, 4.1 / 26          # the res-6 grid spacing


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(26, 132), (3, 10, 16), (7, 6)])
def test_pack_unpack_exact(shape):
    """Packing is pure data movement: bit-exact against the reference and
    an exact round trip."""
    a = _rand(shape)
    r_t, b_t = tp.pack_checkerboard(torch.tensor(a))
    envs = a.reshape((-1,) + shape[-2:])
    for i, env in enumerate(envs):
        r_j, b_j = jp.pack_checkerboard(jnp.asarray(env))
        assert np.array_equal(to_np(r_j), to_np(r_t).reshape(
            (len(envs),) + r_j.shape)[i])
        assert np.array_equal(to_np(b_j), to_np(b_t).reshape(
            (len(envs),) + b_j.shape)[i])
    assert np.array_equal(to_np(tp.unpack_checkerboard(r_t, b_t)), a)


def test_pack_rejects_odd_width():
    with pytest.raises(ValueError, match="even grid width"):
        tp.pack_checkerboard(torch.zeros(4, 5))


# float32 SOR of a unit-variance rhs: solutions are O(0.1-1); the two
# implementations round in different places (XLA fusion vs PyTorch op by
# op), a few ulp per sweep that the contraction keeps bounded -> 1e-5
SOLVE_ATOL = 1e-5


@pytest.mark.parametrize("backend", ["reference", "packed", "full", "pallas"])
def test_solve_matches_reference(backend):
    rhs = _rand((26, 132), seed=1)
    p0 = 0.1 * _rand((26, 132), seed=2)
    ref = jp.solve(jnp.asarray(rhs), DX, DY, iters=30, backend=backend,
                   p0=jnp.asarray(p0))
    out = tp.solve(torch.tensor(rhs), DX, DY, iters=30, backend=backend,
                   p0=torch.tensor(p0))
    assert_close(ref, out, SOLVE_ATOL, backend)


def test_solve_batched_matches_per_env():
    """Leading env dims batch exactly: env i of a batched solve equals the
    solve of env i alone."""
    rhs = _rand((3, 26, 132), seed=3)
    batched = tp.solve(torch.tensor(rhs), DX, DY, iters=12)
    for i in range(3):
        alone = tp.solve(torch.tensor(rhs[i]), DX, DY, iters=12)
        assert_close(alone, batched[i], 1e-6, f"env {i}")


def test_residual_matches_reference():
    p, rhs = _rand((26, 132), 4), _rand((26, 132), 5)
    ref = jp.residual(jnp.asarray(p), jnp.asarray(rhs), DX, DY)
    out = tp.residual(torch.tensor(p), torch.tensor(rhs), DX, DY)
    # O(1/dx^2 ~ 40) terms: float32 rounding of the sum ~ 1e-5
    assert_close(ref, out, 1e-4, "residual")


def test_packed_sweep_pair_matches_reference():
    red, black, rr, rb = (_rand((26, 66), s) for s in range(4))
    row_odd = (np.arange(26) % 2 == 1)[:, None]
    ref = jp.packed_sweep_pair(*map(jnp.asarray, (red, black, rr, rb)), 1.7,
                               dx=DX, dy=DY, row_odd=jnp.asarray(row_odd))
    out = tp.packed_sweep_pair(*map(torch.tensor, (red, black, rr, rb)), 1.7,
                               dx=DX, dy=DY, row_odd=torch.tensor(row_odd))
    for r, o in zip(ref, out):
        assert_close(r, o, 1e-5, "sweep pair")


def test_solve_pallas_odd_width_warns_once_and_falls_back():
    from repro_torch._warn import reset_warning_caches
    reset_warning_caches()
    rhs = torch.tensor(_rand((8, 11)))
    with pytest.warns(RuntimeWarning, match="once per shape"):
        a = tp.solve(rhs, 0.1, 0.1, iters=6, backend="pallas")
    b = tp.solve(rhs, 0.1, 0.1, iters=6, backend="full")
    assert torch.equal(a, b)
    reset_warning_caches()


# the slab twin against the Pallas kernel (interpret mode) and its oracle
@pytest.mark.parametrize("nslabs", [1, 2])
@pytest.mark.parametrize("inner", [1, 3])
def test_slab_twin_matches_pallas_kernel_and_ref(nslabs, inner):
    planes = [_rand((26, 68), s) for s in range(4)]
    kw = dict(dx=DX, dy=DY, omega=1.7, nslabs=nslabs, inner_iters=inner)
    pallas = jkernel.rb_sor_slabs_packed(*map(jnp.asarray, planes),
                                         interpret=True, **kw)
    oracle = jref.rb_sor_slabs_packed_ref(*map(jnp.asarray, planes), **kw)
    twin = tops.rb_sor_slabs_packed(*map(torch.tensor, planes), **kw)
    # a few SOR pairs on unit-variance planes: ulp-level drift only
    for ref_set, name in ((pallas, "pallas"), (oracle, "oracle")):
        for r, o in zip(ref_set, twin):
            assert_close(r, o, 1e-5, name)


def test_rb_sor_planes_round_count_matches_reference():
    """ceil(iters / inner_iters) rounds: iters=10, inner=4 runs 12 pairs,
    as the reference's rb_sor_planes does (not 10)."""
    planes = [_rand((26, 66), s) for s in range(4)]
    ref = jops.rb_sor_planes(*map(jnp.asarray, planes), DX, DY, iters=10,
                             omega=1.7, inner_iters=4, interpret=True)
    out = tops.rb_sor_planes(*map(torch.tensor, planes), DX, DY, iters=10,
                             omega=1.7, inner_iters=4)
    for r, o in zip(ref, out):
        assert_close(r, o, 1e-5, "rb_sor_planes")
    assert tops._pick_nslabs(352) == jops._pick_nslabs(352) == 1


def test_slab_twin_batched():
    planes = [_rand((2, 26, 68), s) for s in range(4)]
    kw = dict(dx=DX, dy=DY, omega=1.7, nslabs=2, inner_iters=2)
    out = tops.rb_sor_slabs_packed(*map(torch.tensor, planes), **kw)
    for i in range(2):
        alone = tops.rb_sor_slabs_packed(
            *(torch.tensor(p[i]) for p in planes), **kw)
        for a, b in zip(alone, out):
            assert_close(a, b[i], 0.0, f"env {i}")


def test_cuda_wrapper_refuses_cpu_tensors():
    planes = [torch.zeros(4, 6) for _ in range(4)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.rb_sor_slabs_packed_cuda(*planes, dx=0.1, dy=0.1, omega=1.7,
                                      nslabs=1, inner_iters=1)


@pytest.mark.parametrize("iters,expect", [(60, 10), (16, 8), (1, 0)])
def test_n_polish_is_the_references(iters, expect):
    """One polish count for every backend and the fused kernel: the
    reference's ``min(polish, iters // 2)`` with polish 10."""
    assert tp.n_polish(iters) == expect == min(10, iters // 2)


def test_slab_kernel_smem_budget():
    """The slab kernel's shared memory, owned by the wrapper: per block the
    largest band of red and black with a halo row each side, of rhs_r and
    rhs_b, four ghost columns and two mbarriers.  One block cannot hold a
    res-18 plane (74, 198), a cluster of 2 or more can; the smallest grid
    that 16 blocks cannot hold at the reference's slab count (res 71: a
    (292, 781) slab, its width left in one slab) raises, and the check
    needs no card."""
    from repro_torch.cfd.grid import GridConfig
    from repro_torch.kernels import SMEM_PER_BLOCK
    assert tops.smem_bytes(66, 176, 1) == 4 * (4 + 2 * 68 * 176
                                               + 2 * 66 * 176 + 4 * 66)
    assert tops.smem_bytes(74, 198, 1) > SMEM_PER_BLOCK
    assert tops.check_planes(74, 198, 1) == 198
    assert min(tops._fitting_clusters(74, 198)) == 2

    def per_block_at_16(res):
        cfg = GridConfig(res=res)
        bxp = cfg.nx // 2 // tops._pick_nslabs(cfg.nx)
        return tops.smem_bytes(cfg.ny, bxp, 16)

    too_big = next(res for res in range(8, 200)
                   if per_block_at_16(res) > SMEM_PER_BLOCK)
    assert too_big == 71
    cfg = GridConfig(res=too_big)
    with pytest.raises(ValueError, match="shared memory"):
        tops.check_planes(cfg.ny, cfg.nx // 2, tops._pick_nslabs(cfg.nx))
