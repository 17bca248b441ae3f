"""Parity of the port's full-grid SOR slab smoother (the plain version of
``csrc/poisson_sor_full.cu``) and of the drop-in ``rb_sor`` in both modes
with the reference's ``repro.kernels.poisson`` (Pallas in interpret mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.poisson import kernel as jkernel
from repro.kernels.poisson import ops as jops
from repro.kernels.poisson import ref as jref
from repro_torch.kernels.poisson import ops as tops
from tests._torch_parity import assert_close

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
    """At res 16 (66 x 352) one slab's p, rhs and ghost columns take
    186,384 bytes, inside one block's 232,448; _pick_nslabs gives 1."""
    assert tops.full_smem_bytes(66, 352) == 186_384
    assert tops._pick_nslabs(352) == 1
