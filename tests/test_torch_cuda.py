"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Skipped without CUDA (a CUDA kernel has no CPU or interpret mode;
the twins are held against the reference in test_torch_poisson.py and
test_torch_solver.py).  Imports no jax and no other test module, so on
a GPU host without jax:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import poisson as tpoisson
from repro_torch.cfd import solver as tsolver
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.poisson import ops as tops
from repro_torch.kernels.rwkv6 import ops as wops

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


def _sor_against_twin(cuda, res, n_env, iters, nslabs=1, cluster=None):
    """rb_sor_planes through the kernel against the plain twin's rounds on
    res-``res`` planes: launches, the launch's cluster and its blocks'
    SMs, and max |kernel - twin|.  The kernel contracts a*b+c into FMAs
    and multiplies by float32 reciprocals of dx^2, dy^2 where the twin
    divides: a few ulp per pair over 52 pairs -> 1e-5 on O(1) planes."""
    cfg = tgrid.GridConfig(res=res)
    planes = [torch.tensor(_rand((n_env, cfg.ny, cfg.nx // 2), s),
                           device=cuda) for s in range(4)]
    rounds = -(-iters // 4)
    n0 = tops.rb_sor_slabs_packed_cuda.launches
    if cluster is None:
        out = tops.rb_sor_planes(*planes, cfg.dx, cfg.dy, iters=iters,
                                 nslabs=nslabs)
    else:
        out = tops.rb_sor_slabs_packed_cuda(
            *planes, dx=cfg.dx, dy=cfg.dy, omega=1.7, nslabs=nslabs,
            inner_iters=4, rounds=rounds, cluster=cluster)
    launches = tops.rb_sor_slabs_packed_cuda.launches - n0
    red, black = planes[:2]
    for _ in range(rounds):
        red, black = tops.rb_sor_slabs_packed_plain(
            red, black, *planes[2:], dx=cfg.dx, dy=cfg.dy, omega=1.7,
            nslabs=nslabs, inner_iters=4)
    torch.cuda.synchronize()
    err = max(max_diff(a, b) for a, b in zip((red, black), out))
    print(f"rb_sor_planes res {res} N={n_env} nslabs={nslabs} cluster="
          f"{tops.rb_sor_slabs_packed_cuda.last_cluster}: max|kernel - "
          f"twin| {err:.3e}")
    assert err <= 1e-5
    return launches, tops.rb_sor_slabs_packed_cuda.last_block_sms


@pytest.mark.cuda
def test_sor_kernel_matches_twin_on_card(cuda):
    """The training shape, res-16 planes, 4 envs, iters=50: 13 rounds in
    one launch, each env spread over a cluster of more than one block
    (16 on an H100), every block on an SM of its own."""
    launches, sms = _sor_against_twin(cuda, 16, 4, 50)
    assert launches == 1
    cluster = tops.rb_sor_slabs_packed_cuda.last_cluster
    assert cluster == tops.cluster_for(66, 176, 1, 4, cuda) > 1
    # the launch's record, -1 where no block ran: every block ran
    assert int((sms >= 0).sum()) == sms.numel() == 4 * cluster > 4
    assert int(sms.unique().numel()) == sms.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_sor_kernel_every_cluster_size_on_card(cuda, cluster):
    """Every cluster size, 13 rounds in one launch, against the twin."""
    assert _sor_against_twin(cuda, 16, 4, 50, cluster=cluster)[0] == 1


@pytest.mark.cuda
def test_sor_kernel_two_slabs_launch_per_round_on_card(cuda):
    """With two slabs a round's ghosts are the other slab's columns: one
    launch a round, 13 at iters=50."""
    assert _sor_against_twin(cuda, 16, 2, 50, nslabs=2)[0] == 13


@pytest.mark.cuda
def test_sor_kernel_serves_res_18_on_card(cuda):
    """A res-18 plane (74, 198), over one block's shared memory, through
    the kernel, and a res-18 backend="pallas" solve."""
    assert _sor_against_twin(cuda, 18, 4, 50)[0] == 1
    assert tops.rb_sor_slabs_packed_cuda.last_cluster > 1
    cfg = tgrid.GridConfig(res=18)
    rhs = torch.tensor(_rand((2, cfg.ny, cfg.nx), 7), device=cuda)
    n0 = tops.rb_sor_slabs_packed_cuda.launches
    p = tpoisson.solve(rhs, cfg.dx, cfg.dy, iters=60, backend="pallas")
    assert tops.rb_sor_slabs_packed_cuda.launches == n0 + 1
    ref = tpoisson.solve(rhs.cpu(), cfg.dx, cfg.dy, iters=60,
                         backend="pallas")
    err = max_diff(ref, p.cpu())
    print(f"solve(backend='pallas') res 18: max|card - cpu| {err:.3e}")
    assert err <= 1e-5


def _fused_inputs(cuda, res, n_env):
    """A res-``res`` grid's geometry and ``n_env`` perturbed impulsive
    starts mixing jets and rotary (per-env jet speeds and modes)."""
    cfg = tgrid.GridConfig(res=res)
    geom = tgrid.build_geometry(cfg)
    ga = tsolver.geom_to_arrays(geom, cuda)
    rng = np.random.default_rng(0)
    flow = tsolver.init_state(cfg, geom, cuda)
    flow = tsolver.FlowState(*(
        a.expand(n_env, *a.shape) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(a.shape)),
            dtype=torch.float32, device=cuda) for a in flow))
    reps = -(-n_env // 4)
    jet = torch.tensor([0.3, -0.5, 0.0, 1.0] * reps, device=cuda)[:n_env]
    mode = torch.tensor([0.0, 0.0, 1.0, 1.0] * reps, device=cuda)[:n_env]
    return cfg, ga, flow, jet, mode


def _fused_against_twin(cuda, res, n_env, n_steps, cluster=None):
    """One kernel launch against the twin.  The kernel contracts a*b+c into
    FMAs, multiplies by float32 reciprocals of the grid constants where the
    twin divides, and sums forces in another order; over 50 dt x 60 SOR
    pairs that stays below 1e-4 on u, v (O(1)), 1e-3 on p (O(5)) and 1e-3
    on C_D and C_L."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, res, n_env)
    n0 = aops.fused_interval_cuda.launches
    if cluster is None:
        a, oa = aops.fused_interval(cfg, ga, flow, jet, n_steps,
                                    act_mode=mode)
    else:
        a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, n_steps,
                                         act_mode=mode, cluster=cluster)
    assert aops.fused_interval_cuda.launches == n0 + 1
    # the launch's record: its cluster size and the SM of every block
    want = aops.cluster_for(cfg, n_env, cuda) if cluster is None else cluster
    assert aops.fused_interval_cuda.last_cluster == want
    sms = aops.fused_interval_cuda.last_block_sms
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sms.numel() == n_env * want
    # -1 where no block ran: every block ran
    assert 0 <= int(sms.min()) and int(sms.max()) < n_sm
    b, ob = aops.fused_interval_plain(cfg, ga, flow, jet, n_steps,
                                      act_mode=mode)
    torch.cuda.synchronize()
    errs = [max_diff(y, x) for x, y in zip(a, b)]
    errs += [max_diff(ob.cd, oa.cd), max_diff(ob.cl, oa.cl)]
    print(f"fused res {res} N={n_env} {n_steps} dt cluster={cluster}: "
          f"max|kernel - twin| u, v, p, cd, cl = {errs}")
    for err, tol in zip(errs, (1e-4, 1e-4, 1e-3, 1e-3, 1e-3)):
        assert err <= tol


@pytest.mark.cuda
def test_fused_kernel_matches_twin_on_card(cuda):
    """The training shape: res 16, 4 envs mixing jets and rotary, one 50-dt
    interval, at the cluster size the wrapper chooses."""
    _fused_against_twin(cuda, 16, 4, 50)


@pytest.mark.cuda
@pytest.mark.parametrize("res,cluster", [(8, 1), (8, 2), (16, 4), (16, 8),
                                         (16, 16)])
def test_fused_kernel_forced_cluster_matches_twin_on_card(cuda, res,
                                                          cluster):
    """Every cluster size against the twin, 4 envs, 50 dt.  A band of one
    env fits one or two blocks only up to res 8 at the default aspect, so
    sizes 1 and 2 run there."""
    _fused_against_twin(cuda, res, 4, 50, cluster=cluster)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [18, 32, 38])
def test_fused_kernel_serves_larger_grids_on_card(cuda, res):
    """Grids over one block's shared memory (res 18: 8 or 16 blocks an env;
    res 32 and res 38, the largest a 16-block cluster holds: 16) through
    the kernel, a few dt against the twin."""
    _fused_against_twin(cuda, res, 4, 5)


@pytest.mark.cuda
def test_fused_kernel_32_envs_matches_twin_on_card(cuda):
    """32 envs, more than 16-block clusters can keep resident: the wrapper
    takes a smaller cluster, all envs against the twin."""
    _fused_against_twin(cuda, 16, 32, 50)


@pytest.mark.cuda
def test_fused_kernel_is_deterministic_on_card(cuda):
    """The cluster-wide sums take one fixed order, without atomics: two
    launches on one input agree bit for bit."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 16, 4)
    runs = [aops.fused_interval_cuda(cfg, ga, flow, jet, 20, act_mode=mode)
            for _ in range(2)]
    torch.cuda.synchronize()
    (a, oa), (b, ob) = runs
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_fused_kernel_refuses_clusters_that_do_not_fit_on_card(cuda):
    """A forced cluster size whose bands do not fit one block's shared
    memory raises and launches nothing (res 16 needs 4 blocks an env)."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 16, 1)
    n0 = aops.fused_interval_cuda.launches
    for cluster in (1, 2, 3, 32):
        with pytest.raises(ValueError, match="cannot hold"):
            aops.fused_interval_cuda(cfg, ga, flow, jet, 1, act_mode=mode,
                                     cluster=cluster)
    assert aops.fused_interval_cuda.launches == n0


@pytest.mark.cuda
def test_grids_the_kernels_cannot_serve_raise_on_card(cuda):
    """On the card there is no fallback: an odd width and a res-71 grid
    (a slab over the shared memory of a 16-block cluster) for the slab
    kernel, and a res-48 grid for the fused kernel (its fields over the
    shared memory of a 16-block cluster) raise instead of running the
    plain loop."""
    rhs = torch.zeros((8, 11), device=cuda)
    with pytest.raises(ValueError, match="even grid width"):
        tpoisson.solve(rhs, 0.1, 0.1, iters=6, backend="pallas")
    big = tgrid.GridConfig(res=71)  # a (292, 781) slab: over 16 blocks
    n0 = tops.rb_sor_slabs_packed_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        tpoisson.solve(torch.zeros((big.ny, big.nx), device=cuda), big.dx,
                       big.dy, iters=6, backend="pallas")
    assert tops.rb_sor_slabs_packed_cuda.launches == n0
    cfg = tgrid.GridConfig(res=48)
    geom = tgrid.build_geometry(cfg)
    n0 = aops.fused_interval_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        tsolver.step_interval(cfg, tsolver.geom_to_arrays(geom, cuda),
                              tsolver.init_state(cfg, geom, cuda), 0.0, 1,
                              backend="fused")
    assert aops.fused_interval_cuda.launches == n0


# a mixed bank batch: (geometry, act_mode, per-body speeds) per env; the
# cylinder's jets ride slot 0, tandem's third slot meets zero planes
BANK_ENVS = (("cylinder", 0.0, (0.3, 0.0, 0.0)),
             ("pinball", 1.0, (0.6, -0.3, 0.1)),
             ("tandem", 1.0, (-0.5, 0.8, 0.4)),
             ("pinball", 1.0, (1.0, 0.2, -0.7)))


def _bank_inputs(cuda, res, n_env):
    """The stacked bank of every geometry at res ``res`` and ``n_env``
    envs cycling through BANK_ENVS, each from its own geometry's perturbed
    impulsive start."""
    cfg = tgrid.GridConfig(res=res)
    names = tgrid.geometry_names()
    geoms = {n: tgrid.build_geometry(cfg, n) for n in names}
    bank = tsolver.geometry_bank(
        [tsolver.geom_to_arrays(geoms[n], cuda) for n in names],
        tgrid.max_bodies())
    envs = [BANK_ENVS[i % len(BANK_ENVS)] for i in range(n_env)]
    rng = np.random.default_rng(1)
    flows = [tsolver.init_state(cfg, geoms[g], cuda) for g, _, _ in envs]
    flow = tsolver.FlowState(*(
        torch.stack(xs) + torch.tensor(
            0.01 * rng.standard_normal((n_env,) + tuple(xs[0].shape)),
            dtype=torch.float32, device=cuda) for xs in zip(*flows)))
    gid = torch.tensor([names.index(g) for g, _, _ in envs], device=cuda)
    mode = torch.tensor([m for _, m, _ in envs], device=cuda)
    amp = torch.tensor([a for _, _, a in envs], device=cuda)
    return cfg, bank, flow, amp, mode, gid


@pytest.mark.cuda
@pytest.mark.parametrize("n_env,n_steps", [(4, 50), (4, 1), (7, 20)])
def test_per_body_kernel_matches_twin_on_card(cuda, n_env, n_steps):
    """The per-body instantiation on a mixed bank batch (cylinder jets,
    pinball and tandem rotary at distinct per-body speeds) against the
    twin, held as the scalar kernel is, each body's C_D / C_L included;
    one launch, recorded as per-body, its cluster and blocks' SMs."""
    cfg, bank, flow, amp, mode, gid = _bank_inputs(cuda, 16, n_env)
    n0 = aops.fused_interval_cuda.launches_per_body
    a, oa = tsolver.step_interval(cfg, bank, flow, amp, n_steps,
                                  act_mode=mode, backend="fused",
                                  geom_id=gid)
    assert aops.fused_interval_cuda.launches_per_body == n0 + 1
    assert aops.fused_interval_cuda.last_n_bodies == tgrid.max_bodies()
    cluster = aops.fused_interval_cuda.last_cluster
    assert cluster == aops.cluster_for(cfg, n_env, cuda, tgrid.max_bodies())
    sms = aops.fused_interval_cuda.last_block_sms
    assert sms.numel() == n_env * cluster and int(sms.min()) >= 0
    assert oa.cd.shape == (n_env, n_steps, 3)
    b, ob = aops.fused_interval_plain(cfg, bank, flow, amp, n_steps,
                                      act_mode=mode, geom_id=gid)
    torch.cuda.synchronize()
    errs = [max_diff(y, x) for x, y in zip(a, b)]
    errs += [max_diff(ob.cd, oa.cd), max_diff(ob.cl, oa.cl)]
    print(f"per-body fused res 16 N={n_env} {n_steps} dt cluster={cluster}:"
          f" max|kernel - twin| u, v, p, cd, cl = {errs}")
    for err, tol in zip(errs, (1e-4, 1e-4, 1e-3, 1e-3, 1e-3)):
        assert err <= tol
    # the cylinder env's padded bodies carry no force
    assert float(oa.cd[0, :, 1:].abs().max()) == 0.0


@pytest.mark.cuda
def test_per_body_kernel_is_deterministic_on_card(cuda):
    """The 2 NB + 1 partial sums take one fixed order: two launches on one
    input agree bit for bit."""
    cfg, bank, flow, amp, mode, gid = _bank_inputs(cuda, 16, 4)
    runs = [aops.fused_interval_cuda(cfg, bank, flow, amp, 20,
                                     act_mode=mode, geom_id=gid)
            for _ in range(2)]
    torch.cuda.synchronize()
    (a, oa), (b, ob) = runs
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_per_body_kernel_single_geometry_on_card(cuda):
    """Without a bank: one pinball geometry (G = 1), and the tandem's two
    bodies padded to the kernel's three, against the twin; a length-1
    vector on the cylinder equals the scalar rotary kernel to summation
    order."""
    cfg = tgrid.GridConfig(res=16)
    for name, amp in (("pinball", (0.6, -0.3, 0.1)), ("tandem", (0.5, -1.0))):
        geom = tgrid.build_geometry(cfg, name)
        ga = tsolver.geom_to_arrays(geom, cuda)
        flow = tsolver.init_state(cfg, geom, cuda)
        jet = torch.tensor(amp, device=cuda)
        a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, 10,
                                         act_mode=1.0)
        b, ob = aops.fused_interval_plain(cfg, ga, flow, jet, 10,
                                          act_mode=1.0)
        torch.cuda.synchronize()
        assert oa.cd.shape == ob.cd.shape == (10, len(amp))
        for x, y, tol in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl),
                             (1e-4, 1e-4, 1e-3, 1e-3, 1e-3)):
            assert max_diff(x, y) <= tol, name
    geom = tgrid.build_geometry(cfg)
    ga = tsolver.geom_to_arrays(geom, cuda)
    flow = tsolver.init_state(cfg, geom, cuda)
    a, oa = aops.fused_interval_cuda(cfg, ga, flow, 0.7, 10, act_mode=1.0)
    b, ob = aops.fused_interval_cuda(cfg, ga, flow,
                                     torch.tensor([0.7], device=cuda), 10,
                                     act_mode=1.0)
    torch.cuda.synchronize()
    assert aops.fused_interval_cuda.last_n_bodies == 3
    for x, y in zip(a, b):
        assert max_diff(x, y) <= 1e-5
    assert max_diff(oa.cd, ob.cd.sum(-1)) <= 1e-4


@pytest.mark.cuda
def test_scalar_kernel_over_a_bank_of_one_geometry_on_card(cuda):
    """A scalar amplitude over the bank whose envs all pick one geometry
    (a cylinder batch of a multi-body env) launches the scalar
    instantiation on that geometry, as the geometry alone does."""
    cfg, bank, _, _, _, _ = _bank_inputs(cuda, 16, 4)
    _, _, flow, jet, mode = _fused_inputs(cuda, 16, 4)
    gid = torch.full((4,), tgrid.geometry_index("cylinder"), device=cuda)
    ga = tsolver.geom_to_arrays(tgrid.build_geometry(cfg), cuda)
    a, oa = aops.fused_interval_cuda(cfg, bank, flow, jet, 10,
                                     act_mode=mode, geom_id=gid)
    assert aops.fused_interval_cuda.last_n_bodies == 0
    b, ob = aops.fused_interval_cuda(cfg, ga, flow, jet, 10, act_mode=mode)
    torch.cuda.synchronize()
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_per_body_calls_the_kernel_cannot_serve_raise_on_card(cuda):
    """No fallback on the card: a vector call on a grid the per-body
    instantiation cannot hold, a vector without the per-body fields, and
    a scalar amplitude over a bank that mixes geometries raise and launch
    nothing."""
    n0 = aops.fused_interval_cuda.launches
    cfg = tgrid.GridConfig(res=48)
    geom = tgrid.build_geometry(cfg, "pinball")
    with pytest.raises(ValueError, match="shared memory"):
        tsolver.step_interval(cfg, tsolver.geom_to_arrays(geom, cuda),
                              tsolver.init_state(cfg, geom, cuda),
                              torch.zeros(3, device=cuda), 1,
                              act_mode=1.0, backend="fused")
    cfg, bank, flow, amp, mode, gid = _bank_inputs(cuda, 8, 4)
    with pytest.raises(ValueError, match="per-body geometry fields"):
        aops.fused_interval_cuda(cfg, bank._replace(rotb_u=None), flow, amp,
                                 1, act_mode=mode, geom_id=gid)
    with pytest.raises(ValueError, match="one geometry per launch"):
        aops.fused_interval_cuda(cfg, bank, flow, amp[:, 0], 1,
                                 act_mode=mode, geom_id=gid)
    assert aops.fused_interval_cuda.launches == n0


def _sor_full_against_twin(cuda, res, n_env, iters, nslabs=None,
                           cluster=None):
    """rb_sor(packed=False) through the full-grid kernel against the plain
    twin's rounds on random res-``res`` grids from a warm start: launches,
    the launch's cluster and its blocks' SMs, and max |kernel - twin|.
    The kernel splits the grid into packed planes, contracts a*b+c into
    FMAs and multiplies by float32 reciprocals of dx^2, dy^2 where the
    twin divides: a few ulp per pair over 52 pairs -> 1e-5 on O(1)
    fields."""
    cfg = tgrid.GridConfig(res=res)
    shape = (n_env, cfg.ny, cfg.nx)
    rhs = torch.tensor(_rand(shape, 5), device=cuda)
    p0 = torch.tensor(0.1 * _rand(shape, 6), device=cuda)
    nslabs = nslabs or tops._pick_nslabs(cfg.nx)
    rounds = -(-iters // 4)
    n0 = tops.rb_sor_slabs_cuda.launches
    if cluster is None:
        out = tops.rb_sor(rhs, cfg.dx, cfg.dy, p0=p0, iters=iters, omega=1.7,
                          nslabs=nslabs, inner_iters=4, packed=False)
    else:
        out = p0
        for _ in range(1 if nslabs == 1 else rounds):
            out = tops.rb_sor_slabs_cuda(
                out, rhs, dx=cfg.dx, dy=cfg.dy, omega=1.7, nslabs=nslabs,
                inner_iters=4, rounds=rounds if nslabs == 1 else 1,
                cluster=cluster)
    launches = tops.rb_sor_slabs_cuda.launches - n0
    p = p0
    for _ in range(rounds):
        p = tops.rb_sor_slabs_plain(p, rhs, dx=cfg.dx, dy=cfg.dy, omega=1.7,
                                    nslabs=nslabs, inner_iters=4)
    torch.cuda.synchronize()
    err = max_diff(p, out)
    print(f"rb_sor(packed=False) res {res} N={n_env} nslabs={nslabs} "
          f"cluster={tops.rb_sor_slabs_cuda.last_cluster}: max|kernel - "
          f"twin| {err:.3e}")
    assert err <= 1e-5
    return launches, tops.rb_sor_slabs_cuda.last_block_sms


@pytest.mark.cuda
@pytest.mark.parametrize("nslabs", [1, 2, 4])
def test_sor_full_kernel_matches_twin_on_card(cuda, nslabs):
    """The full-grid kernel against its twin through the drop-in solve:
    res-16 grid (66, 352), 4 envs, iters=50, 13 rounds: one launch with
    one slab (each grid spread over a cluster of more than one block, every
    block on an SM of its own), one launch a round with several."""
    launches, sms = _sor_full_against_twin(cuda, 16, 4, 50, nslabs=nslabs)
    assert launches == (1 if nslabs == 1 else 13)
    cluster = tops.rb_sor_slabs_cuda.last_cluster
    assert cluster == tops.cluster_for(66, 176, nslabs, 4, cuda,
                                       full=True) > 1
    assert int((sms >= 0).sum()) == sms.numel() == 4 * nslabs * cluster
    if nslabs == 1:
        assert int(sms.unique().numel()) == sms.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("nslabs", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_sor_full_kernel_every_cluster_size_on_card(cuda, cluster, nslabs):
    """Every cluster size that fits the res-16 slab, at one slab (13 rounds
    in one launch) and at two (a launch a round), against the twin."""
    launches = _sor_full_against_twin(cuda, 16, 4, 50, nslabs=nslabs,
                                      cluster=cluster)[0]
    assert launches == (1 if nslabs == 1 else 13)
    assert tops.rb_sor_slabs_cuda.last_cluster == cluster


@pytest.mark.cuda
@pytest.mark.parametrize("res", [18, 70])
def test_sor_full_kernel_serves_large_grids_on_card(cuda, res):
    """Res 18 (74, 396), which a one-block design could not hold, in one
    slab: one launch per solve; and res 70 (288, 1540), the largest grid
    16-block clusters hold at the reference's slab count, two slabs of 770
    columns: a launch a round.  Against the twin."""
    cfg = tgrid.GridConfig(res=res)
    nslabs = tops._pick_nslabs(cfg.nx)
    assert nslabs == {18: 1, 70: 2}[res]
    launches = _sor_full_against_twin(cuda, res, 2, 50)[0]
    assert launches == (1 if nslabs == 1 else 13)
    assert tops.rb_sor_slabs_cuda.last_cluster > 1


@pytest.mark.cuda
def test_sor_full_kernel_refuses_res_71_on_card(cuda):
    """No fallback on the card: a res-71 grid (292, 1562), whose one slab
    no 16-block cluster holds, raises and launches nothing; so do a
    cluster size that does not hold the slab and several rounds over
    several slabs."""
    big = tgrid.GridConfig(res=71)
    z = torch.zeros((big.ny, big.nx), device=cuda)
    n0 = tops.rb_sor_slabs_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        tops.rb_sor(z, big.dx, big.dy, iters=8, packed=False)
    cfg = tgrid.GridConfig(res=18)
    z = torch.zeros((cfg.ny, cfg.nx), device=cuda)
    with pytest.raises(ValueError, match="cannot hold"):
        tops.rb_sor_slabs_cuda(z, z, dx=cfg.dx, dy=cfg.dy, omega=1.7,
                               nslabs=1, inner_iters=4, cluster=1)
    with pytest.raises(ValueError, match="several with one"):
        tops.rb_sor_slabs_cuda(z, z, dx=cfg.dx, dy=cfg.dy, omega=1.7,
                               nslabs=2, inner_iters=4, rounds=2)
    assert tops.rb_sor_slabs_cuda.launches == n0


def _decay(rng, shape):
    """RWKV-6 decays as the model makes them: exp(-exp(w0 + d)) with the
    configs' w0 = -6 and a data term d ~ N(0, 0.5)."""
    return np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))


# (B, S, H, Hkv, dh, causal, window): dh 32 / 64 / 128 under GQA, a window
# across the 128-key tile edge, S = 40 (a 40-key tile, not a multiple of
# 16, in one 128-row box) and 96, non-causal; dh 48 and 96 (padded to 64
# and 128 by the wrapper), causal and under a window
FLASH_CASES = [(2, 256, 4, 2, 64, True, 0), (2, 256, 4, 2, 128, True, 96),
               (1, 64, 4, 4, 32, True, 0), (1, 96, 2, 1, 64, True, 0),
               (1, 256, 2, 2, 64, False, 0), (1, 40, 4, 2, 32, True, 0),
               (2, 384, 6, 2, 32, True, 0), (1, 384, 8, 2, 128, True, 0),
               (1, 512, 4, 1, 128, True, 200), (1, 40, 2, 1, 128, False, 0),
               (1, 256, 4, 2, 48, True, 0), (1, 256, 4, 2, 96, True, 96)]


def _worst_row(ref, out) -> float:
    """The largest max |out - ref| of a row over max |ref| of that row."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_twin_on_card(cuda, case, dtype):
    """The flash kernel of the dtype (GQA mapped in the kernel; bfloat16 on
    the tensor cores, float32 on the CUDA cores) against the plain twin (KV
    heads repeated, naive softmax).  float32: another summation order,
    ~1e-6 on O(1) outputs -> 2e-5.  bfloat16: p is rounded to bf16 at the
    running max in the kernel and after normalising in the twin, and the
    output is rounded to bf16 (2^-8 relative): a few bf16 ulp at |o| <= 2
    -> 3e-2.  bfloat16 is also held to the tile-exact oracle
    flash_attention_tiled, which rounds p where the kernel does: the two
    fp32 results differ by the order of the sums and exp2f against exp
    (~1 fp32 ulp of p), so a bf16 output differs by one rounding step, one
    ulp of its row's largest |o| (2^-7 of it), and by at most one more
    where a p rounds to another bf16 value in the two: 2^-6."""
    B, S, H, Hkv, dh, causal, window = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + dh)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, dh)),
                            dtype=torch.float32, device=cuda).to(dt)
               for h in (H, Hkv, Hkv))
    wrapper = (fops.flash_attention_bf16_cuda if dtype == "bfloat16"
               else fops.flash_attention_fp32_cuda)
    n0 = wrapper.launches
    out = fops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    assert wrapper.launches == n0 + 1
    ref = fops.flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    err = max_diff(ref.float(), out.float())
    print(f"flash {case} {dtype}: max|kernel - twin| {err:.3e}")
    assert err <= (2e-5 if dtype == "float32" else 3e-2)
    if dtype == "bfloat16":
        tiled = fops.flash_attention_tiled(q, k, v, causal=causal,
                                           sliding_window=window)
        row = _worst_row(tiled, out)
        print(f"flash {case} bf16: worst row vs tiled {row:.3e}")
        assert row <= 2 ** -6


@pytest.mark.cuda
def test_flash_bf16_runs_on_the_tensor_core_kernel(cuda):
    """A bfloat16 CUDA call launches the tensor-core kernel and never the
    float32 one; a float32 call the reverse; float16 raises and launches
    nothing."""
    def counts():
        return (fops.flash_attention_bf16_cuda.launches,
                fops.flash_attention_fp32_cuda.launches)

    q = torch.zeros((1, 128, 2, 64), device=cuda)
    n_tc, n_fp32 = counts()
    fops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert counts() == (n_tc + 1, n_fp32)
    fops.flash_attention(q, q, q)
    assert counts() == (n_tc + 1, n_fp32 + 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fops.flash_attention(q.half(), q.half(), q.half())
    assert counts() == (n_tc + 1, n_fp32 + 1)


def test_flash_rejects_lengths_the_reference_rejects():
    """S must be a multiple of min(128, S), as the reference asserts."""
    q = torch.zeros((1, 200, 2, 32))
    with pytest.raises(ValueError, match="not a multiple"):
        fops.flash_attention(q, q, q)


# (B, S, H, N, chunk): chunks of 32, of 25 (padded to 32 in the kernel)
# and a single chunk of 16; head sizes 64, 32, 128 and 16, and 48, 80 and
# 192 (a scan over fewer threads than the block's, k~^T v a tile a call,
# the largest head); heads of 24 and 40 (padded to 32 and 48 by the
# wrapper) and a chunk of 64 asked for (run at 32)
WKV_CASES = [(2, 128, 2, 64, 32), (1, 100, 3, 32, 32), (1, 16, 1, 64, 32),
             (1, 64, 2, 128, 32), (2, 96, 3, 16, 32), (1, 96, 3, 48, 32),
             (1, 64, 2, 80, 32), (1, 64, 1, 192, 32), (1, 64, 2, 24, 32),
             (1, 128, 2, 40, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_twin_on_card(cuda, case, dtype):
    """The chunked WKV6 kernel against the sequential twin.  The chunked
    algebra reassociates the recurrence (exp of cumulative log-decays), so
    float32 agrees to ~1e-6 of the output's scale -> 2e-5 relative to the
    largest |out|, the state likewise.  bfloat16 inputs are the same for
    both; the bf16 outputs differ by at most one rounding step, one ulp of
    the largest |out| (2^-7 of it), the float32 state by 2e-5."""
    B, S, H, N, chunk = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + N)

    def t(a, d=dt):
        return torch.tensor(a, dtype=torch.float32, device=cuda).to(d)

    r, k, v = (t(rng.standard_normal((B, S, H, N))) for _ in range(3))
    w = t(_decay(rng, (B, S, H, N)), torch.float32)
    u = t(0.1 * rng.standard_normal((H, N)))
    s0 = t(0.1 * rng.standard_normal((B, H, N, N)), torch.float32)
    n0 = wops.wkv6_cuda.launches
    out, s_fin = wops.wkv6(r, k, v, w, u, s0, chunk=chunk)
    assert wops.wkv6_cuda.launches == n0 + 2    # chunk pass, state pass
    assert out.shape == r.shape and s_fin.shape == s0.shape
    # the state pass's record of its blocks' SMs, -1 where none ran: one
    # block per (batch, head, 16 value columns of the padded state)
    sms = wops.wkv6_cuda.last_block_sms
    ran = int((sms >= 0).sum())
    assert ran == sms.numel() == B * H * -(-N // 16)
    assert N == 16 or ran > B * H
    ref, s_ref = wops.wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert out.dtype == dt and s_fin.dtype == torch.float32
    scale = float(ref.float().abs().max())
    err = max_diff(ref.float(), out.float()) / scale
    s_err = max_diff(s_ref, s_fin) / float(s_ref.abs().max())
    print(f"wkv6 {case} {dtype}: max|kernel - twin| / max|out| {err:.3e}, "
          f"state {s_err:.3e}")
    assert err <= (2e-5 if dtype == "float32" else 2 ** -7)
    assert s_err <= 2e-5


@pytest.mark.cuda
def test_wkv6_raises_on_head_sizes_it_was_not_built_for(cuda):
    """A head of 24, which the kernel is not built for, runs padded to 32
    and agrees with the twin (bf16: one rounding step of the largest
    |out|, the state 2e-5); a head of 208, whose state-pass block would
    not fit shared memory, raises and launches nothing."""
    rng = np.random.default_rng(24)
    x = torch.tensor(rng.standard_normal((3, 1, 32, 2, 24)),
                     dtype=torch.float32, device=cuda).bfloat16()
    w = torch.tensor(_decay(rng, (1, 32, 2, 24)), dtype=torch.float32,
                     device=cuda)
    u = torch.tensor(0.1 * rng.standard_normal((2, 24)), dtype=torch.float32,
                     device=cuda)
    s0 = torch.zeros((1, 2, 24, 24), device=cuda)
    n0 = wops.wkv6_cuda.launches
    out, s_fin = wops.wkv6(*x, w, u, s0)
    assert wops.wkv6_cuda.launches == n0 + 2
    ref, s_ref = wops.wkv6_plain(*x, w, u, s0)
    torch.cuda.synchronize()
    assert max_diff(ref.float(), out.float()) \
        <= 2 ** -7 * float(ref.float().abs().max())
    assert max_diff(s_ref, s_fin) <= 2e-5 * float(s_ref.abs().max())
    x = torch.zeros((1, 32, 2, 208), device=cuda, dtype=torch.bfloat16)
    n0 = wops.wkv6_cuda.launches
    with pytest.raises(ValueError, match="head sizes"):
        wops.wkv6(x, x, x, x.float(), torch.zeros((2, 208), device=cuda),
                  torch.zeros((1, 2, 208, 208), device=cuda))
    assert wops.wkv6_cuda.launches == n0


@pytest.mark.cuda
def test_flash_raises_on_head_dims_it_was_not_built_for(cuda):
    """A head dim of 48, which the kernels are not built for, runs padded
    to 64 on the kernel of its dtype and agrees with the twin (float32
    2e-5, bfloat16 3e-2, as above); 192 raises and launches nothing."""
    def counts():
        return (fops.flash_attention_bf16_cuda.launches,
                fops.flash_attention_fp32_cuda.launches)

    rng = np.random.default_rng(48)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 3e-2)):
        q = torch.tensor(rng.standard_normal((1, 128, 2, 48)),
                         dtype=torch.float32, device=cuda).to(dt)
        n0 = counts()
        out = fops.flash_attention(q, q, q)
        assert sum(counts()) == sum(n0) + 1
        ref = fops.flash_attention_plain(q, q, q)
        torch.cuda.synchronize()
        assert out.shape == q.shape and out.dtype == dt
        assert max_diff(ref.float(), out.float()) <= tol
        q = torch.zeros((1, 64, 2, 192), device=cuda, dtype=dt)
        n0 = counts()
        with pytest.raises(ValueError, match="head dims"):
            fops.flash_attention(q, q, q)
        assert counts() == n0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "rwkv6-3b"])
def test_lm_forward_on_card(cuda, name):
    """forward_train of the reduced config (float32, 2 layers; phi4-mini
    with 2 KV heads for the GQA mapping) on the card: backend "pallas"
    launches its kernel once per layer (WKV6: its two passes) and agrees
    with "reference" to 2e-5 on the O(1) logits (float32, another
    summation order)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = get_config(name).reduced()
    if cfg.attention_kind == "gqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    params = model.init_params(cfg, seed=0, device=cuda)
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)), device=cuda)
    wrapper, per_layer = ((fops.flash_attention_fp32_cuda, 1)
                          if cfg.attention_kind == "gqa"
                          else (wops.wkv6_cuda, 2))
    n0 = wrapper.launches
    out, _ = model.forward_train(cfg, params, tokens, backend="pallas")
    assert wrapper.launches - n0 == per_layer * cfg.num_layers
    ref, _ = model.forward_train(cfg, params, tokens, backend="reference")
    torch.cuda.synchronize()
    err = max_diff(ref, out)
    print(f"forward_train {name} reduced: max|pallas - reference| {err:.3e}")
    assert err <= 2e-5


# ---------------------------------------------------------------------------
# the robust training path through the fused kernel
# ---------------------------------------------------------------------------

@pytest.fixture
def deterministic(cuda, monkeypatch):
    """torch.use_deterministic_algorithms for one test: an op of the path
    with no deterministic implementation raises instead of drifting."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _robust_cfg(episodes, ckpt_dir=None, **kw):
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.drl.ppo import PPOConfig
    from repro_torch.drl.train import TrainConfig
    return TrainConfig(
        env=EnvConfig(grid=tgrid.GridConfig(res=8), steps_per_action=10,
                      actions_per_episode=4, warmup_time=1.0),
        ppo=PPOConfig(epochs=2, minibatches=2), n_envs=4, episodes=episodes,
        seed=0, scenarios=("cyl_re100", "pinball_re100"), policy="attention",
        ckpt_dir=ckpt_dir, ckpt_every=1, device="cuda", **kw)


@pytest.mark.cuda
def test_train_bitwise_resume_through_fused_kernel_on_card(cuda,
                                                            deterministic,
                                                            tmp_path):
    """The attention policy on a mixed cylinder + pinball batch, res 8, 4
    envs: train(episodes=1) then a resume to 2 equals train(episodes=2)
    bit for bit (params, Adam moments, generator state, history), each
    interval one launch of the per-body instantiation, and the resume
    launches no warmup."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.train import train
    w = aops.fused_interval_cuda

    def launches(fn):
        n0, b0 = w.launches, w.launches_per_body
        out = fn()
        return out, (w.launches - n0, w.launches_per_body - b0)

    (hist_a, model_a), la = launches(lambda: train(
        _robust_cfg(2, str(tmp_path / "A")), log_fn=None))
    _, lk = launches(lambda: train(_robust_cfg(1, str(tmp_path / "B")),
                                   log_fn=None))
    (hist_b, model_b), lb = launches(lambda: train(
        _robust_cfg(2, str(tmp_path / "B"), resume=True), log_fn=None))
    assert la == (2 + 8, 8) and lk == (2 + 4, 4) and lb == (4, 4)
    for (k, a), b in zip(model_a.state_dict().items(),
                         model_b.state_dict().values()):
        assert torch.equal(a, b), k
    for f in ("reward", "cd", "cl", "quarantines", "grad_skips"):
        np.testing.assert_array_equal(hist_a[f], hist_b[f])
    ts_a, _ = ts_mod.load_train_state(
        ck.latest_checkpoint(str(tmp_path / "A")), cuda)
    ts_b, _ = ts_mod.load_train_state(
        ck.latest_checkpoint(str(tmp_path / "B")), cuda)
    assert torch.equal(ts_a.rng, ts_b.rng) and ts_a.step == ts_b.step
    for k in ("m", "v"):
        for x, y in zip(ts_a.opt_state[k], ts_b.opt_state[k]):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("scenarios", [("cyl_re100",),
                                       ("cyl_re100", "pinball_re100")])
def test_nan_env_isolated_across_envs_and_clusters_on_card(cuda,
                                                           deterministic,
                                                           scenarios):
    """A NaN in env 1's u at step 0 reaches the sentinel (env 1 quarantined,
    reset to its warmup flow) and no other env's cluster: the other envs'
    fields equal those of the same step without the fault, bit for bit.
    The cylinder batch runs the scalar instantiation <0>, the mixed one the
    per-body <3>."""
    from repro_torch.cfd.env import CylinderEnv, EnvConfig
    from repro_torch.testing import faults
    env = CylinderEnv(EnvConfig(grid=tgrid.GridConfig(res=8),
                                steps_per_action=20, warmup_time=1.0),
                      backend="fused", device=cuda)
    st, _ = env.reset_batch(scenarios, 4)
    act = torch.linspace(-0.5, 0.5, 4, device=cuda)
    if st.jet_vel.dim() > 1:
        act = act[:, None].expand(4, st.jet_vel.shape[-1])
    per_body = int(st.jet_vel.dim() > 1)
    n0, b0 = aops.fused_interval_cuda.launches, \
        aops.fused_interval_cuda.launches_per_body
    clean, clean_out = env.env_step(st, act)
    faults.configure({"nan_env": {"env": 1, "step": 0}})
    try:
        hit, out = env.env_step(st, act)
    finally:
        faults.reset()
    torch.cuda.synchronize()
    assert aops.fused_interval_cuda.launches - n0 == 2
    assert aops.fused_interval_cuda.launches_per_body - b0 == 2 * per_body
    assert aops.fused_interval_cuda.last_cluster > 1
    assert torch.equal(out.valid, torch.tensor([1.0, 0.0, 1.0, 1.0],
                                               device=cuda))
    keep = [0, 2, 3]
    for a, b in zip(hit.flow, clean.flow):
        assert torch.equal(a[keep], b[keep])
    for a, b in zip(hit.flow, st.reset_flow):
        assert torch.equal(a[1], b[1])
    for f in ("obs", "reward", "cd", "cl"):
        assert torch.equal(getattr(out, f)[keep], getattr(clean_out, f)[keep])
    assert all(torch.isfinite(a).all() for a in hit.flow)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["mlp", "attention"])
def test_record_replay_bitwise_through_fused_kernel_on_card(cuda,
                                                            deterministic,
                                                            tmp_path,
                                                            policy):
    """train(sink=SinkSpec(kind="dataset")) on a mixed cylinder + pinball
    batch, res 8, 4 envs, then replay_sync of the dataset from the seed in
    its manifest: params, Adam moments, PPO step, generator state and
    returns equal to the live run's bit for bit, and the replay launches
    no fused kernel."""
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.data.trajectory_dataset import TrajectoryReader
    from repro_torch.drl import networks
    from repro_torch.drl import train_state as ts_mod
    from repro_torch.drl.engine import EngineConfig, RolloutEngine, SinkSpec
    from repro_torch.drl.train import train
    cfg = dataclasses.replace(
        _robust_cfg(2, str(tmp_path / "ck"),
                    sink=SinkSpec(kind="dataset", root=str(tmp_path / "ds"))),
        policy=policy)
    hist, model = train(cfg, log_fn=None)
    live, _ = ts_mod.load_train_state(
        ck.latest_checkpoint(str(tmp_path / "ck")), cuda)
    reader = TrajectoryReader(str(tmp_path / "ds"))
    meta = reader.metadata
    engine = RolloutEngine(None, EngineConfig(
        n_envs=meta["n_envs"], horizon=meta["horizon"], gamma=cfg.ppo.gamma,
        lam=cfg.ppo.lam))
    pcfg = networks.PolicyConfig(**meta["policy"])
    model_r, optimizer, opt_state, gen = engine.init(pcfg, cfg.ppo,
                                                     meta["seed"], cuda)
    n0 = aops.fused_interval_cuda.launches
    model_r, opt_state, returns = engine.replay_sync(
        reader, model_r, opt_state, cfg.ppo, optimizer, len(reader),
        generator=gen)
    assert aops.fused_interval_cuda.launches == n0
    for (k, a), b in zip(model_r.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in ("m", "v"):
        for x, y in zip(opt_state[k], live.opt_state[k]):
            assert torch.equal(x, y)
    assert torch.equal(gen.get_state(), live.rng)
    np.testing.assert_array_equal(returns, hist["reward"])
