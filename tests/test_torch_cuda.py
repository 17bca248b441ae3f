"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Skipped without CUDA (a CUDA kernel has no CPU or interpret mode;
the twins are held against the reference in test_torch_poisson.py and
test_torch_solver.py).  Imports no jax and no other test module, so on
a GPU host without jax:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import poisson as tpoisson
from repro_torch.cfd import solver as tsolver
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.poisson import ops as tops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (decided here, not at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a hand-written CUDA kernel has no "
                    "CPU or interpret mode (its plain twin is tested here)")
    return torch.device("cuda")


def max_diff(a, b) -> float:
    return float((a - b).abs().max())


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.cuda
def test_sor_kernel_matches_twin_on_card(cuda):
    """The CUDA kernel against its twin on the card, res-16 planes, 4 envs.
    FMA contraction in the kernel rounds differently from the twin's op by
    op float32: a few ulp per pair over 52 pairs -> 1e-5 on O(1) planes."""
    planes = [torch.tensor(_rand((4, 66, 176), s), device=cuda)
              for s in range(4)]
    n0 = tops.rb_sor_slabs_packed_cuda.launches
    out = tops.rb_sor_planes(*planes, 22.0 / 352, 4.1 / 66, iters=50)
    assert tops.rb_sor_slabs_packed_cuda.launches - n0 == 13
    red, black = planes[:2]
    for _ in range(13):
        red, black = tops.rb_sor_slabs_packed_plain(
            red, black, *planes[2:], dx=22.0 / 352, dy=4.1 / 66, omega=1.7,
            nslabs=1, inner_iters=4)
    torch.cuda.synchronize()
    for a, b in zip((red, black), out):
        assert max_diff(a, b) <= 1e-5


@pytest.mark.cuda
def test_fused_kernel_matches_twin_on_card(cuda):
    """The CUDA kernel against its twin on the card: res 16, 4 envs mixing
    jets and rotary, one 50-dt interval.  The kernel contracts a*b+c into
    FMAs and sums forces in another order; over 50 dt x 60 SOR pairs that
    stays below 1e-4 on u, v (O(1)), 1e-3 on p (O(5)) and 1e-3 on C_D."""
    cfg = tgrid.GridConfig(res=16)
    geom = tgrid.build_geometry(cfg)
    ga = tsolver.geom_to_arrays(geom, cuda)
    rng = np.random.default_rng(0)
    flow = tsolver.init_state(cfg, geom, cuda)
    flow = tsolver.FlowState(*(
        a.expand(4, *a.shape) + torch.tensor(
            0.01 * rng.standard_normal((4,) + tuple(a.shape)),
            dtype=torch.float32, device=cuda) for a in flow))
    jet = torch.tensor([0.3, -0.5, 0.0, 1.0], device=cuda)
    mode = torch.tensor([0.0, 0.0, 1.0, 1.0], device=cuda)
    n0 = aops.fused_interval_cuda.launches
    a, oa = aops.fused_interval(cfg, ga, flow, jet, 50, act_mode=mode)
    assert aops.fused_interval_cuda.launches == n0 + 1
    b, ob = aops.fused_interval_plain(cfg, ga, flow, jet, 50, act_mode=mode)
    torch.cuda.synchronize()
    for x, y, tol in zip(a, b, (1e-4, 1e-4, 1e-3)):
        assert max_diff(y, x) <= tol
    assert max_diff(ob.cd, oa.cd) <= 1e-3


@pytest.mark.cuda
def test_grids_the_kernels_cannot_serve_raise_on_card(cuda):
    """On the card there is no fallback: an odd width for the slab kernel
    and a res-18 grid for the fused kernel (its packed planes over one
    block's shared memory) raise instead of running the plain loop."""
    rhs = torch.zeros((8, 11), device=cuda)
    with pytest.raises(ValueError, match="even grid width"):
        tpoisson.solve(rhs, 0.1, 0.1, iters=6, backend="pallas")
    cfg = tgrid.GridConfig(res=18)
    geom = tgrid.build_geometry(cfg)
    n0 = aops.fused_interval_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        tsolver.step_interval(cfg, tsolver.geom_to_arrays(geom, cuda),
                              tsolver.init_state(cfg, geom, cuda), 0.0, 1,
                              backend="fused")
    assert aops.fused_interval_cuda.launches == n0
