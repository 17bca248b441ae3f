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
# the float16 twins' products accumulate in float32, as the kernels' do
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


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


# dt past res 70: explicit Euler diffusion is stable for dt <= Re h^2 / 4
# (h the cell size), 2.72e-3 at res 96 at Re 100, below the default 5e-3
FINE_DT = {96: 0.002}


def _grid(res):
    """The res-``res`` grid, at a stable dt on the finest grids."""
    if res in FINE_DT:
        return tgrid.GridConfig(res=res, dt=FINE_DT[res])
    return tgrid.GridConfig(res=res)


def _fused_inputs(cuda, res, n_env):
    """A res-``res`` grid's geometry and ``n_env`` perturbed impulsive
    starts mixing jets and rotary (per-env jet speeds and modes)."""
    cfg = _grid(res)
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


def _fused_against_twin(cuda, res, n_env, n_steps, cluster=None, **kw):
    """One kernel call against the twin (``kw``: ``force_global``).  The
    kernel contracts a*b+c into FMAs, multiplies by float32 reciprocals of
    the grid constants where the twin divides, and sums forces in another
    order; over 50 dt x 60 SOR pairs that stays below 1e-4 on u, v (O(1)),
    1e-3 on p (O(5)) and 1e-3 on C_D and C_L."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, res, n_env)
    n0 = aops.fused_interval_cuda.launches
    if cluster is None and not kw:
        a, oa = aops.fused_interval(cfg, ga, flow, jet, n_steps,
                                    act_mode=mode)
    else:
        a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, n_steps,
                                         act_mode=mode, cluster=cluster,
                                         **kw)
    # one launch, or one a launch's worth of groups the card holds at once
    assert aops.fused_interval_cuda.launches == (
        n0 + aops.fused_interval_cuda.last_plan.launches)
    # the launch's record: its cluster size and the SM of every block
    want = cluster or aops.launch_plan(cfg, n_env, cuda, **kw).size
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


class _OddGrid(tgrid.GridConfig):
    """res 8 one column narrower: (34, 175), an odd width."""
    nx = property(lambda self: 22 * self.res - 1)


@pytest.mark.cuda
def test_only_odd_widths_raise_on_card(cuda):
    """On the card there is no fallback, and an odd width runs its kernel
    as an even one does (no fallback counted, no warning): a pallas solve
    on (8, 11) is one launch of the full-grid library's full sweeps, a
    fused interval at res 8 one column narrower one launch of the fused
    kernel, each within its tolerance of the CPU's reference path (the
    full-grid sweep; the reference scan).  A res-71 solve (a (292, 781)
    slab, over the shared memory of a 16-block cluster) runs on the packed
    SOR's resident kernel, one launch, and a res-48 interval (its fields
    over the shared memory of a 16-block cluster) on the fused kernel's,
    one launch; each within its tolerance of the CPU's twin."""
    import warnings
    from repro_torch import kernels
    f0 = dict(kernels.FALLBACKS)
    rhs = torch.tensor(_rand((8, 11), 3), device=cuda)
    p0 = 0.1 * torch.tensor(_rand((8, 11), 4), device=cuda)
    n0 = tops.full_sweeps_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p = tpoisson.solve(rhs, 0.1, 0.1, iters=60, p0=p0, backend="pallas")
    assert tops.full_sweeps_cuda.launches == n0 + 1
    assert tops.full_sweeps_cuda.last_kernel == "cluster"
    ref = tpoisson.solve(rhs.cpu(), 0.1, 0.1, iters=60, p0=p0.cpu(),
                         backend="full")
    assert max_diff(ref, p.cpu()) <= 1e-5
    odd = _OddGrid(res=8)
    geom = tgrid.build_geometry(odd)
    n0 = aops.fused_interval_cuda.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        flow, outs = tsolver.step_interval(
            odd, tsolver.geom_to_arrays(geom, cuda),
            tsolver.init_state(odd, geom, cuda), 0.3, 10, backend="fused")
    assert aops.fused_interval_cuda.launches == n0 + 1
    assert aops.fused_interval_cuda.last_kernel == "cluster"
    want, wouts = tsolver.step_interval(
        odd, tsolver.geom_to_arrays(geom, "cpu"),
        tsolver.init_state(odd, geom, "cpu"), 0.3, 10, backend="reference")
    for x, y, tol in zip((*flow, outs.cd), (*want, wouts.cd),
                         (1e-4, 1e-4, 1e-3, 1e-3)):
        assert max_diff(x.cpu(), y) <= tol
    assert dict(kernels.FALLBACKS) == f0
    big = tgrid.GridConfig(res=71)
    rhs = torch.tensor(_rand((big.ny, big.nx), 9), device=cuda)
    n0 = tops.rb_sor_slabs_packed_cuda.launches_resident
    p = tpoisson.solve(rhs, big.dx, big.dy, iters=8, backend="pallas")
    assert tops.rb_sor_slabs_packed_cuda.launches_resident == n0 + 1
    assert tops.rb_sor_slabs_packed_cuda.last_kernel == "resident"
    ref = tpoisson.solve(rhs.cpu(), big.dx, big.dy, iters=8,
                         backend="pallas")
    assert max_diff(ref, p.cpu()) <= 1e-5
    cfg = tgrid.GridConfig(res=48)
    geom = tgrid.build_geometry(cfg)
    n0 = aops.fused_interval_cuda.launches_resident
    flow, outs = tsolver.step_interval(
        cfg, tsolver.geom_to_arrays(geom, cuda),
        tsolver.init_state(cfg, geom, cuda), 0.0, 1, backend="fused")
    assert aops.fused_interval_cuda.launches_resident == n0 + 1
    assert aops.fused_interval_cuda.last_kernel == "resident"
    want, wouts = tsolver.step_interval(
        cfg, tsolver.geom_to_arrays(geom, "cpu"),
        tsolver.init_state(cfg, geom, "cpu"), 0.0, 1, backend="fused")
    for x, y, tol in zip((*flow, outs.cd), (*want, wouts.cd),
                         (1e-4, 1e-4, 1e-3, 1e-3)):
        assert max_diff(x.cpu(), y) <= tol
    assert dict(kernels.FALLBACKS) == f0


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
    cfg = _grid(res)
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
    """No fallback on the card: a vector without the per-body fields and
    a scalar amplitude over a bank that mixes geometries raise and launch
    nothing (a grid past one cluster runs on the resident or the
    global-memory kernel: test_fused_resident_kernel_matches_twin_on_card,
    test_fused_global_kernel_matches_twin_on_card)."""
    n0 = aops.fused_interval_cuda.launches
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
def test_sor_full_kernel_serves_res_71_on_card(cuda):
    """No fallback on the card: a res-71 grid (292, 1562), whose one slab
    no 16-block cluster holds, runs on the resident kernel, one launch a
    solve, within the twin's tolerance; a cluster size that does not hold a
    slab and several rounds over several slabs raise and launch
    nothing."""
    launches, sms = _sor_full_against_twin(cuda, 71, 1, 8)
    assert launches == 1 and tops.rb_sor_slabs_cuda.last_kernel == "resident"
    assert int(sms.min()) >= 0
    cfg = tgrid.GridConfig(res=18)
    z = torch.zeros((cfg.ny, cfg.nx), device=cuda)
    n0 = tops.rb_sor_slabs_cuda.launches
    with pytest.raises(ValueError, match="cannot hold"):
        tops.rb_sor_slabs_cuda(z, z, dx=cfg.dx, dy=cfg.dy, omega=1.7,
                               nslabs=1, inner_iters=4, cluster=1)
    with pytest.raises(ValueError, match="several with one"):
        tops.rb_sor_slabs_cuda(z, z, dx=cfg.dx, dy=cfg.dy, omega=1.7,
                               nslabs=2, inner_iters=4, rounds=2)
    assert tops.rb_sor_slabs_cuda.launches == n0


# ---------------------------------------------------------------------------
# the global-memory kernels: the grids no cluster holds
# ---------------------------------------------------------------------------

def _bank_against_twin(cuda, res, n_env, n_steps, **kw):
    """The per-body instantiation on a mixed bank batch against its twin,
    held as _fused_against_twin holds the scalar one; returns the
    kernel's result."""
    cfg, bank, flow, amp, mode, gid = _bank_inputs(cuda, res, n_env)
    a, oa = aops.fused_interval_cuda(cfg, bank, flow, amp, n_steps,
                                     act_mode=mode, geom_id=gid, **kw)
    assert aops.fused_interval_cuda.last_n_bodies == tgrid.max_bodies()
    b, ob = aops.fused_interval_plain(cfg, bank, flow, amp, n_steps,
                                      act_mode=mode, geom_id=gid)
    torch.cuda.synchronize()
    errs = [max_diff(y, x) for x, y in zip(a, b)]
    errs += [max_diff(ob.cd, oa.cd), max_diff(ob.cl, oa.cl)]
    print(f"per-body fused res {res} N={n_env} {n_steps} dt "
          f"{aops.fused_interval_cuda.last_kernel} "
          f"G={aops.fused_interval_cuda.last_cluster}: max|kernel - twin| "
          f"u, v, p, cd, cl = {errs}")
    for err, tol in zip(errs, (1e-4, 1e-4, 1e-3, 1e-3, 1e-3)):
        assert err <= tol
    return a, oa


@pytest.mark.cuda
@pytest.mark.parametrize("res,n_steps", [(48, 10), (96, 3)])
def test_fused_global_kernel_matches_twin_on_card(cuda, res, n_steps):
    """Past one cluster (res 48: ny 198, nx 1056, which the resident
    kernel serves unless forced; res 96: 394 x 2112) the global-memory
    kernel, scalar and per-body on a mixed bank batch, 4 envs, one launch,
    every block on an SM, against the twin at the cluster kernel's
    tolerances."""
    n0 = aops.fused_interval_cuda.launches_global
    _fused_against_twin(cuda, res, 4, n_steps, force_global=True)
    assert aops.fused_interval_cuda.launches_global == n0 + 1
    assert aops.fused_interval_cuda.last_kernel == "global"
    _bank_against_twin(cuda, res, 4, n_steps, force_global=True)
    assert aops.fused_interval_cuda.launches_global == n0 + 2
    plan = aops.fused_interval_cuda.last_plan
    assert (plan.kernel, plan.launches) == ("global", 1)


@pytest.mark.cuda
def test_fused_global_kernel_is_deterministic_on_card(cuda):
    """The partial sums added in block order on every block: two launches
    on one input agree bit for bit, scalar and per-body."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 48, 4)
    runs = [aops.fused_interval_cuda(cfg, ga, flow, jet, 5, act_mode=mode,
                                     force_global=True)
            for _ in range(2)]
    cfg, bank, flow, amp, mode, gid = _bank_inputs(cuda, 48, 4)
    runs += [aops.fused_interval_cuda(cfg, bank, flow, amp, 5,
                                      act_mode=mode, geom_id=gid,
                                      force_global=True)
             for _ in range(2)]
    torch.cuda.synchronize()
    for (a, oa), (b, ob) in (runs[:2], runs[2:]):
        for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fused_global_env_alone_equals_batch_at_pinned_group_on_card(cuda):
    """G orders the sums, as the cluster size does: env 0 of a 4-env launch
    equals a 1-env launch at the same G bit for bit (a fleet's shard runs
    each env as the whole batch would)."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 48, 4)
    g = aops.launch_plan(cfg, 4, cuda, force_global=True).size
    a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, 5, act_mode=mode,
                                     force_global=True)
    assert aops.fused_interval_cuda.last_cluster == g
    one = tsolver.FlowState(*(x[:1] for x in flow))
    b, ob = aops.fused_interval_cuda(cfg, ga, one, jet[:1], 5,
                                     act_mode=mode[:1], cluster=g,
                                     force_global=True)
    torch.cuda.synchronize()
    assert aops.fused_interval_cuda.last_cluster == g
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert torch.equal(x[:1], y)


@pytest.mark.cuda
def test_fused_global_kernel_beside_cluster_kernel_on_card(cuda):
    """On res 38, which both kernels serve, the global-memory kernel at the
    cluster kernel's size against the cluster kernel: within the twin's
    tolerances (the per-point arithmetic and the order of the sums are the
    same, so the two are expected to agree bit for bit; reported)."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 38, 4)
    a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, 10, act_mode=mode)
    assert aops.fused_interval_cuda.last_kernel == "cluster"
    size = aops.fused_interval_cuda.last_cluster
    b, ob = aops.fused_interval_cuda(cfg, ga, flow, jet, 10, act_mode=mode,
                                     cluster=size, force_global=True)
    assert aops.fused_interval_cuda.last_kernel == "global"
    torch.cuda.synchronize()
    pairs = list(zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)))
    print(f"fused res 38 global vs cluster at {size} blocks: bit-equal "
          f"{all(torch.equal(x, y) for x, y in pairs)}, max diff "
          f"{[max_diff(x, y) for x, y in pairs]}")
    for (x, y), tol in zip(pairs, (1e-4, 1e-4, 1e-3, 1e-3, 1e-3)):
        assert max_diff(x, y) <= tol


@pytest.mark.cuda
def test_fused_global_kernel_runs_envs_past_residency_on_card(cuda):
    """More envs than the card holds at once at a pinned G: several
    cooperative launches, never one env's blocks in waves, each env equal
    to a launch of its own."""
    n = aops.resident_blocks(cuda, tgrid.GridConfig(res=40), 32) // 32 + 1
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 40, n)
    n0 = aops.fused_interval_cuda.launches
    a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, 2, act_mode=mode,
                                     cluster=32, force_global=True)
    plan = aops.fused_interval_cuda.last_plan
    assert plan.launches == 2 == aops.fused_interval_cuda.launches - n0
    last = tsolver.FlowState(*(x[-1:] for x in flow))
    b, ob = aops.fused_interval_cuda(cfg, ga, last, jet[-1:], 2,
                                     act_mode=mode[-1:], cluster=32,
                                     force_global=True)
    torch.cuda.synchronize()
    for x, y in zip((*a, oa.cd), (*b, ob.cd)):
        assert torch.equal(x[-1:], y)


def _sor_pair(cuda, res, n_env, iters, full, seed=3, **kw):
    """One solve of the packed (or ``full``) SOR kernel at res ``res`` on
    random inputs through the wrapper; returns (result, twin's)."""
    cfg = tgrid.GridConfig(res=res)
    nslabs = tops._pick_nslabs(cfg.nx)
    rounds = -(-iters // 4)
    k = dict(dx=cfg.dx, dy=cfg.dy, omega=1.7, nslabs=nslabs, inner_iters=4)
    if full:
        shape = (n_env, cfg.ny, cfg.nx)
        rhs = torch.tensor(_rand(shape, seed), device=cuda)
        p = torch.tensor(0.1 * _rand(shape, seed + 1), device=cuda)
        out, want = p, p
        for _ in range(1 if nslabs == 1 else rounds):
            out = tops.rb_sor_slabs_cuda(
                out, rhs, rounds=rounds if nslabs == 1 else 1, **k, **kw)
        for _ in range(rounds):
            want = tops.rb_sor_slabs_plain(want, rhs, **k)
        return (out,), (want,)
    planes = [torch.tensor(_rand((n_env, cfg.ny, cfg.nx // 2), seed + s),
                           device=cuda) for s in range(4)]
    out = planes[:2]
    for _ in range(1 if nslabs == 1 else rounds):
        out = tops.rb_sor_slabs_packed_cuda(
            *out, *planes[2:], rounds=rounds if nslabs == 1 else 1, **k,
            **kw)
    want = planes[:2]
    for _ in range(rounds):
        want = tops.rb_sor_slabs_packed_plain(*want, *planes[2:], **k)
    return tuple(out), tuple(want)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("res,n_env", [(71, 2), (98, 2)])
def test_sor_global_kernel_matches_twin_on_card(cuda, full, res, n_env):
    """Past one cluster: res 71 (292 x 1562, one slab: one launch a solve)
    and res 98 (402 x 2156, two slabs: one launch a round), which the
    resident kernel serves unless forced, through the global-memory
    kernel, packed and full-grid, against the twin within 1e-5; two solves
    agree bit for bit."""
    wrapper = tops.rb_sor_slabs_cuda if full else tops.rb_sor_slabs_packed_cuda
    n0 = wrapper.launches_global
    out, want = _sor_pair(cuda, res, n_env, 50, full, force_global=True)
    launches = wrapper.launches_global - n0
    assert wrapper.last_kernel == "global"
    assert launches == (1 if res == 71 else 13)
    again, _ = _sor_pair(cuda, res, n_env, 50, full, force_global=True)
    torch.cuda.synchronize()
    err = max(max_diff(x, y) for x, y in zip(out, want))
    print(f"SOR {'full' if full else 'packed'} res {res} global "
          f"G={wrapper.last_cluster}: max|kernel - twin| {err:.3e}")
    assert err <= 1e-5
    for x, y in zip(out, again):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_sor_global_kernel_equals_cluster_kernel_on_card(cuda, full):
    """On res 70, which both kernels serve (two slabs of (288, 385) packed
    columns), the global-memory kernel at the cluster kernel's size gives
    the cluster kernel's bits: the same half-sweep on the same rows."""
    wrapper = tops.rb_sor_slabs_cuda if full else tops.rb_sor_slabs_packed_cuda
    a, _ = _sor_pair(cuda, 70, 2, 50, full)
    assert wrapper.last_kernel == "cluster"
    b, _ = _sor_pair(cuda, 70, 2, 50, full, cluster=wrapper.last_cluster,
                     force_global=True)
    assert wrapper.last_kernel == "global"
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)



# ---------------------------------------------------------------------------
# the resident kernels: bands in shared memory over several clusters
# ---------------------------------------------------------------------------

def _equal(a, b):
    """Whether two fused results (flow, outputs) or two tuples of planes
    agree bit for bit, and their largest difference."""
    if not isinstance(a[0], torch.Tensor):
        a = (*a[0], a[1].cd, a[1].cl)
        b = (*b[0], b[1].cd, b[1].cl)
    return (all(torch.equal(x, y) for x, y in zip(a, b)),
            max(max_diff(x, y) for x, y in zip(a, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("res", [40, 48, 52])
def test_fused_resident_kernel_matches_twin_on_card(cuda, res):
    """Res 40, 48 and 52 (the first, a middle and the last grid the
    resident kernel serves) run on it by default, scalar and per-body on
    a mixed bank batch, 4 envs, each launch's groups no more than the card
    holds at once, every block on an SM, against the twin at the cluster
    kernel's tolerances."""
    n0 = aops.fused_interval_cuda.launches_resident
    _fused_against_twin(cuda, res, 4, 10)
    plan = aops.fused_interval_cuda.last_plan
    assert (plan.kernel, plan.size % plan.cluster) == ("resident", 0)
    assert plan.cluster in (16, 8, 4, 2) and plan.size // plan.cluster >= 2
    assert aops.fused_interval_cuda.launches_resident == n0 + plan.launches
    _bank_against_twin(cuda, res, 4, 10)
    assert aops.fused_interval_cuda.last_kernel == "resident"


@pytest.mark.cuda
@pytest.mark.parametrize("per_body", [False, True])
def test_fused_resident_kernel_equals_global_kernel_on_card(cuda, per_body):
    """Res 48, 4 envs, 50 dt: the resident kernel at G 32 gives the bits
    of the global-memory kernel at G 32, scalar and per-body on the mixed
    bank batch: each point's arithmetic and the order of the G partial
    sums are the same."""
    if per_body:
        cfg, geom, flow, amp, mode, gid = _bank_inputs(cuda, 48, 4)
        kw = dict(act_mode=mode, geom_id=gid)
    else:
        cfg, geom, flow, amp, mode = _fused_inputs(cuda, 48, 4)
        kw = dict(act_mode=mode)
    a = aops.fused_interval_cuda(cfg, geom, flow, amp, 50, **kw)
    plan = aops.fused_interval_cuda.last_plan
    assert (plan.kernel, plan.size) == ("resident", 32)
    b = aops.fused_interval_cuda(cfg, geom, flow, amp, 50, cluster=32,
                                 force_global=True, **kw)
    assert aops.fused_interval_cuda.last_kernel == "global"
    torch.cuda.synchronize()
    equal, diff = _equal(a, b)
    print(f"fused res 48 resident {plan} vs global at G 32: bit-equal "
          f"{equal}, max diff {diff:.3e}")
    assert equal


@pytest.mark.cuda
def test_fused_resident_env_alone_equals_batch_on_card(cuda):
    """G orders the sums, whatever the clusters: env 0 of a 4-env launch
    equals a 1-env launch at the same G bit for bit (a fleet's shard runs
    each env as the whole batch would)."""
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 48, 4)
    g = aops.cluster_for(cfg, 4, cuda)
    a, oa = aops.fused_interval_cuda(cfg, ga, flow, jet, 5, act_mode=mode)
    assert aops.fused_interval_cuda.last_kernel == "resident"
    one = tsolver.FlowState(*(x[:1] for x in flow))
    b, ob = aops.fused_interval_cuda(cfg, ga, one, jet[:1], 5,
                                     act_mode=mode[:1], cluster=g)
    torch.cuda.synchronize()
    assert aops.fused_interval_cuda.last_plan.size == g
    for x, y in zip((*a, oa.cd, oa.cl), (*b, ob.cd, ob.cl)):
        assert torch.equal(x[:1], y)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("res", [71, 98])
def test_sor_resident_kernel_equals_global_kernel_on_card(cuda, full, res):
    """Res 71 (one slab) and res 98 (two slabs): the resident kernel, packed
    and full-grid, within 1e-5 of the twin and bit-equal to the
    global-memory kernel at the same G (the same half-sweep on the same
    rows, the same ghosts and rounds)."""
    wrapper = tops.rb_sor_slabs_cuda if full else tops.rb_sor_slabs_packed_cuda
    n0 = wrapper.launches_resident
    out, want = _sor_pair(cuda, res, 4, 50, full)
    plan = wrapper.last_plan
    assert plan.kernel == "resident"
    calls = 1 if res == 71 else 13
    assert wrapper.launches_resident - n0 == calls * plan.launches
    forced, _ = _sor_pair(cuda, res, 4, 50, full, cluster=plan.size,
                          force_global=True)
    assert wrapper.last_kernel == "global"
    torch.cuda.synchronize()
    err = max(max_diff(x, y) for x, y in zip(out, want))
    equal, diff = _equal(out, forced)
    print(f"SOR {'full' if full else 'packed'} res {res} resident {plan}: "
          f"max|kernel - twin| {err:.3e}; bit-equal to global {equal} "
          f"({diff:.3e})")
    assert err <= 1e-5 and equal


def _built_without_cross_cluster_wait(tmp_path, names):
    """The libraries ``names`` built from copies of the sources whose
    resident kernels skip the wait on the cross-cluster neighbour's row
    (csrc/resident.cuh wait_tagged: each word taken as it stands, not
    polled until it carries the phase), loaded."""
    import ctypes
    import subprocess
    from repro_torch.kernels import build
    for src in {f for n in names for f in build.SOURCES[n]}:
        text = (build.CSRC / src).read_text()
        if src == "resident.cuh":
            line = ("for (unsigned polls = 0; static_cast<unsigned>(w >> 32) "
                    "!= gen; ++polls) {")
            assert text.count(line) == 1
            text = text.replace(line, "for (unsigned polls = 0; false; "
                                      "++polls) {")
        (tmp_path / src).write_text(text)
    procs = {n: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
         str(tmp_path / f"lib{n}.so"), str(tmp_path / build.SOURCES[n][0])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in names}
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        lib = ctypes.CDLL(str(tmp_path / f"lib{n}.so"))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        libs[n] = lib
    return libs


@pytest.mark.cuda
def test_resident_planted_cross_cluster_fault_is_rejected_on_card(
        cuda, tmp_path):
    """The bit gate sees a missing cross-cluster wait: built without it,
    the fused resident kernel at res 48 and the packed SOR's at res 71 no
    longer give the global-memory kernel's bits (a row copied before its
    neighbour wrote it is a half-sweep stale)."""
    from repro_torch.kernels import build
    wrong = _built_without_cross_cluster_wait(
        tmp_path, ("fused_interval", "poisson_sor"))
    cfg, ga, flow, jet, mode = _fused_inputs(cuda, 48, 4)
    right = aops.fused_interval_cuda(cfg, ga, flow, jet, 50, act_mode=mode,
                                     cluster=32, force_global=True)
    planes_right, _ = _sor_pair(cuda, 71, 4, 50, False, cluster=24,
                                force_global=True)
    saved = dict(build._LIBS)
    try:
        build._LIBS.update(wrong)  # the wrappers set argtypes on first use
        faulty = aops.fused_interval_cuda(cfg, ga, flow, jet, 50,
                                          act_mode=mode)
        assert aops.fused_interval_cuda.last_kernel == "resident"
        planes_faulty, _ = _sor_pair(cuda, 71, 4, 50, False)
        assert tops.rb_sor_slabs_packed_cuda.last_kernel == "resident"
        torch.cuda.synchronize()
    finally:
        build._LIBS.clear()
        build._LIBS.update(saved)
    fused_equal, fused_diff = _equal(right, faulty)
    sor_equal, sor_diff = _equal(planes_right, planes_faulty)
    print(f"planted cross-cluster fault: fused bit-equal {fused_equal} "
          f"({fused_diff:.3e}), SOR bit-equal {sor_equal} ({sor_diff:.3e})")
    assert not fused_equal and not sor_equal


@pytest.mark.cuda
def test_train_at_res_48_runs_on_the_resident_kernel_on_card(cuda):
    """train() at res 48 (4 envs, 1 episode of 4 actions after a 1 t.u.
    warmup): every fused call (the warmup and each interval) on the
    resident kernel, none on the global-memory one, rewards and params
    finite."""
    from repro_torch.cfd.env import EnvConfig
    from repro_torch.drl.train import TrainConfig, train
    w = aops.fused_interval_cuda
    grid = tgrid.GridConfig(res=48)
    plan = aops.launch_plan(grid, 4, cuda)
    assert plan.kernel == "resident"
    n0, r0, g0 = w.launches, w.launches_resident, w.launches_global
    hist, model = train(TrainConfig(
        env=EnvConfig(grid=grid, steps_per_action=50, actions_per_episode=4,
                      warmup_time=1.0),
        n_envs=4, episodes=1, seed=0, device="cuda"), log_fn=None)
    calls = 1 + 4
    assert w.launches_resident - r0 == calls * plan.launches
    assert w.launches - n0 == calls * plan.launches
    assert w.launches_global == g0
    assert np.isfinite(hist["reward"]).all()
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def _fleet(workdir, processes, res=48):
    """A fleet of ``processes`` runners on the card at ``res`` (4 envs, 1
    episode of 2 actions of 10 dt after a 0.1 t.u. warmup); returns its
    stdout."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    workdir.mkdir()
    env = {"PYTHONPATH": str(root / "src"),
           "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(workdir), "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", "--device",
         "cuda", "--processes", str(processes), "--episodes", "1",
         "--res", str(res), "--dt", "0.005", "--poisson-iters", "60",
         "--steps-per-action", "10", "--actions-per-episode", "2",
         "--warmup", "0.1", "--workdir", str(workdir),
         "--launch-timeout", "500"],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=str(root))
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    assert "FLEET_DONE episodes=1" in out.stdout
    return out.stdout


@pytest.mark.cuda
def test_fleet_at_res_48_on_the_resident_kernel_on_card(cuda, tmp_path):
    """Two runners sharing the card at res 48 each run their env shard on
    the resident kernel at the whole batch's G, and the 2-process fleet's
    final checkpoint equals the 1-process fleet's bit for bit."""
    from repro_torch.ckpt.checkpoint import latest_checkpoint
    from repro_torch.drl.train_state import load_train_state
    states = {}
    for procs in (1, 2):
        stdout = _fleet(tmp_path / f"p{procs}", procs)
        timing = [ln for ln in stdout.splitlines()
                  if ln.startswith("FLEET_TIMING")][-1]
        t = dict(kv.split("=") for kv in timing.split()[1:])
        assert int(t["fused_resident_launches"]) > 0
        assert int(t["fused_resident_launches"]) == int(t["fused_launches"])
        assert int(t["fused_cluster"]) == 32
        states[procs] = load_train_state(
            latest_checkpoint(str(tmp_path / f"p{procs}" / "ckpt")), "cpu")
    (ts1, meta1), (ts2, meta2) = states[1], states[2]
    assert meta1["episode"] == meta2["episode"] == 1
    assert meta2["plan"]["n_processes"] == 2
    for k in ts1.params:
        assert torch.equal(ts1.params[k], ts2.params[k]), k
    for k in ("m", "v"):
        for x, y in zip(ts1.opt_state[k], ts2.opt_state[k]):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fleet_at_res_56_on_the_global_memory_kernel_on_card(cuda,
                                                             tmp_path):
    """Past res 52 (the global-memory kernel): each runner's every fused
    launch on that kernel at the whole batch's G, none resident, and the
    2-process fleet's final checkpoint equals the 1-process fleet's bit
    for bit."""
    from repro_torch.ckpt.checkpoint import latest_checkpoint
    from repro_torch.drl.train_state import load_train_state
    plan = aops.launch_plan(tgrid.GridConfig(res=56), 4, cuda)
    assert plan.kernel == "global"
    states = {}
    for procs in (1, 2):
        stdout = _fleet(tmp_path / f"p{procs}", procs, res=56)
        timing = [ln for ln in stdout.splitlines()
                  if ln.startswith("FLEET_TIMING")][-1]
        t = dict(kv.split("=") for kv in timing.split()[1:])
        assert int(t["fused_launches"]) > 0
        assert int(t["fused_resident_launches"]) == 0
        assert int(t["fused_cluster"]) == plan.size
        states[procs] = load_train_state(
            latest_checkpoint(str(tmp_path / f"p{procs}" / "ckpt")), "cpu")
    (ts1, meta1), (ts2, meta2) = states[1], states[2]
    assert meta1["episode"] == meta2["episode"] == 1
    assert meta2["plan"]["n_processes"] == 2
    for k in ts1.params:
        assert torch.equal(ts1.params[k], ts2.params[k]), k
    for k in ("m", "v"):
        for x, y in zip(ts1.opt_state[k], ts2.opt_state[k]):
            assert torch.equal(x, y)

def _decay(rng, shape):
    """RWKV-6 decays as the model makes them: exp(-exp(w0 + d)) with the
    configs' w0 = -6 and a data term d ~ N(0, 0.5)."""
    return np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))


# (B, S, H, Hkv, dh, causal, window): dh 32 / 64 / 128 under GQA, a window
# across the 128-key tile edge, S = 40 (a 40-key tile, not a multiple of
# 16, in one 128-row box) and 96, non-causal; dh 48 and 96 (padded to 64
# and 128 by the wrapper), causal and under a window; the wide heads: dh
# 256 (the bf16 kernel's split consumers, the float32 kernel's one K/V
# buffer) grouped and not, causal, windowed, non-causal and in one 40-key
# tile, and 160 and 192 padded to 256; past 256 the column-split kernels:
# dh 320 (two groups of 256 columns on the tensor cores, the second with 64
# columns; three of 128 on the CUDA cores), 384 non-causal, 512 under a
# window, 576, 320 in one 40-key tile, and 300 padded to 320
FLASH_CASES = [(2, 256, 4, 2, 64, True, 0), (2, 256, 4, 2, 128, True, 96),
               (1, 64, 4, 4, 32, True, 0), (1, 96, 2, 1, 64, True, 0),
               (1, 256, 2, 2, 64, False, 0), (1, 40, 4, 2, 32, True, 0),
               (2, 384, 6, 2, 32, True, 0), (1, 384, 8, 2, 128, True, 0),
               (1, 512, 4, 1, 128, True, 200), (1, 40, 2, 1, 128, False, 0),
               (1, 256, 4, 2, 48, True, 0), (1, 256, 4, 2, 96, True, 96),
               (1, 1024, 25, 5, 64, True, 256),
               # qwen2-vl's group of 6 at dh 128, seamless-m4t's group of 1
               (1, 512, 12, 2, 128, True, 0), (1, 512, 16, 16, 64, True, 0),
               (1, 256, 4, 2, 256, True, 0), (1, 384, 4, 4, 256, True, 100),
               (2, 256, 4, 1, 192, True, 0), (1, 256, 2, 2, 160, True, 96),
               (1, 128, 2, 1, 256, False, 0), (1, 40, 2, 1, 256, True, 0),
               (1, 256, 4, 2, 320, True, 0), (1, 128, 2, 2, 384, False, 0),
               (1, 256, 2, 1, 512, True, 100), (1, 128, 2, 1, 576, True, 0),
               (1, 40, 2, 1, 320, True, 0), (1, 256, 2, 2, 300, True, 0)]
# tolerances by dtype: against the plain twin, and the worst row against
# the tile-exact oracle (see the test)
FLASH_TOL = {"float32": (2e-5, None), "bfloat16": (3e-2, 2 ** -6),
             "float16": (4e-3, 2 ** -9)}
FLASH_WRAPPERS = {"float32": "flash_attention_fp32_cuda",
                  "bfloat16": "flash_attention_bf16_cuda",
                  "float16": "flash_attention_f16_cuda"}


def _worst_row(ref, out) -> float:
    """The largest max |out - ref| of a row over max |ref| of that row."""
    d = (out.float() - ref.float()).abs().amax(-1)
    return float((d / ref.float().abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_twin_on_card(cuda, case, dtype):
    """The flash kernel of the dtype (GQA mapped in the kernel; bfloat16
    and float16 on the tensor cores, float32 on the CUDA cores) against the
    plain twin (KV heads repeated, naive softmax).  float32: another
    summation order, ~1e-6 on O(1) outputs -> 2e-5.  bfloat16: p is rounded
    to bf16 at the running max in the kernel and after normalising in the
    twin, and the output is rounded to bf16 (2^-8 relative): a few bf16 ulp
    at |o| <= 2 -> 3e-2; float16 rounds at the same places with 3 more
    bits -> 4e-3.  The tensor-core kernels are also held to the tile-exact
    oracle flash_attention_tiled, which rounds p where the kernel does: the
    two fp32 results differ by the order of the sums and exp2f against exp
    (~1 fp32 ulp of p), so an output differs by one rounding step, one ulp
    of its row's largest |o| (bf16 2^-7 of it, float16 2^-10), and by at
    most one more where a p rounds to another value in the two: 2^-6 and
    2^-9."""
    B, S, H, Hkv, dh, causal, window = case
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + dh)
    q, k, v = (torch.tensor(rng.standard_normal((B, S, h, dh)),
                            dtype=torch.float32, device=cuda).to(dt)
               for h in (H, Hkv, Hkv))
    wrapper = getattr(fops, FLASH_WRAPPERS[dtype])
    n0 = wrapper.launches
    out = fops.flash_attention(q, k, v, causal=causal, sliding_window=window)
    assert wrapper.launches == n0 + 1
    ref = fops.flash_attention_plain(q, k, v, causal=causal,
                                     sliding_window=window)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    tol, tol_row = FLASH_TOL[dtype]
    err = max_diff(ref.float(), out.float())
    print(f"flash {case} {dtype}: max|kernel - twin| {err:.3e}")
    assert err <= tol
    if tol_row is not None:
        tiled = fops.flash_attention_tiled(q, k, v, causal=causal,
                                           sliding_window=window)
        row = _worst_row(tiled, out)
        print(f"flash {case} {dtype}: worst row vs tiled {row:.3e}")
        assert row <= tol_row


@pytest.mark.cuda
def test_flash_bf16_runs_on_the_tensor_core_kernel(cuda):
    """A bfloat16 CUDA call launches the bf16 tensor-core kernel and no
    other; a float16 call its float16 instantiation; a float32 call the
    CUDA-core kernel; float64, which no kernel takes, raises and launches
    nothing."""
    def counts():
        return (fops.flash_attention_bf16_cuda.launches,
                fops.flash_attention_f16_cuda.launches,
                fops.flash_attention_fp32_cuda.launches)

    q = torch.zeros((1, 128, 2, 64), device=cuda)
    n_tc, n_f16, n_fp32 = counts()
    fops.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert counts() == (n_tc + 1, n_f16, n_fp32)
    fops.flash_attention(q.half(), q.half(), q.half())
    assert counts() == (n_tc + 1, n_f16 + 1, n_fp32)
    fops.flash_attention(q, q, q)
    assert counts() == (n_tc + 1, n_f16 + 1, n_fp32 + 1)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fops.flash_attention(q.double(), q.double(), q.double())
    assert counts() == (n_tc + 1, n_f16 + 1, n_fp32 + 1)


def test_flash_rejects_lengths_the_reference_rejects():
    """S must be a multiple of min(128, S), as the reference asserts."""
    q = torch.zeros((1, 200, 2, 32))
    with pytest.raises(ValueError, match="not a multiple"):
        fops.flash_attention(q, q, q)


# (B, S, H, N, chunk): chunks of 32, of 25 (padded to 32 in the kernel)
# and a single chunk of 16; head sizes 64, 32, 128 and 16, and 48, 80 and
# 192 (a scan over fewer threads than the block's, k~^T v a tile a call,
# the largest head of one block); heads of 24 and 40 (padded to 32 and 48
# by the wrapper) and a chunk of 64 asked for (run at 32); past 192 the
# cluster passes, S 256: 208, 256, 320, 512 and 1024 (clusters of 4, 4, 5,
# 8 and 16 blocks), 200 (padded to 208), and 256 in chunks of 25; past 1024
# several clusters a problem and the add of their parts: 1088 (2 x 9
# blocks), 1280 (2 x 10) in chunks of 25, and 1100 padded to 1152 (2 x 9)
WKV_CASES = [(2, 128, 2, 64, 32), (1, 100, 3, 32, 32), (1, 16, 1, 64, 32),
             (1, 64, 2, 128, 32), (2, 96, 3, 16, 32), (1, 96, 3, 48, 32),
             (1, 64, 2, 80, 32), (1, 64, 1, 192, 32), (1, 64, 2, 24, 32),
             (1, 128, 2, 40, 64), (1, 256, 2, 200, 32), (1, 256, 1, 208, 32),
             (1, 256, 2, 256, 32), (2, 256, 1, 320, 32),
             (1, 256, 1, 512, 32), (1, 256, 1, 1024, 32),
             (1, 200, 1, 256, 25), (1, 128, 1, 1088, 32),
             (1, 100, 2, 1280, 25), (1, 64, 1, 1100, 32)]
# the bound on max |kernel - twin| of the output over its largest |value|:
# float32 the chunked algebra's reassociation, the others one rounding
# step of the output's type
WKV_TOL = {"float32": 2e-5, "bfloat16": 2 ** -7, "float16": 2 ** -10}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_kernel_matches_twin_on_card(cuda, case, dtype):
    """The chunked WKV6 kernel against the sequential twin.  The chunked
    algebra reassociates the recurrence (exp of cumulative log-decays), so
    float32 agrees to ~1e-6 of the output's scale -> 2e-5 relative to the
    largest |out|, the state likewise.  bfloat16 and float16 inputs are the
    same for both; their outputs differ by at most one rounding step, one
    ulp of the largest |out| (2^-7 of it in bf16, 2^-10 in float16), the
    float32 state by 2e-5."""
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
    # chunk pass, state pass (past 1024 the add of the clusters' parts)
    assert wops.wkv6_cuda.launches == n0 + wops.launches_per_call(N)
    assert out.shape == r.shape and s_fin.shape == s0.shape
    # the state pass's record of its blocks' SMs, -1 where none ran: one
    # block per (batch, head, 16 value columns of the padded state), a
    # cluster of them past 192, several past 1024
    sms = wops.wkv6_cuda.last_block_sms
    ran = int((sms >= 0).sum())
    n = wops.kernel_head_size(N)
    nc, g = wops.head_split(n)
    assert ran == sms.numel() == B * H * (n // 16) * nc * g
    assert N == 16 or ran > B * H
    ref, s_ref = wops.wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert out.dtype == dt and s_fin.dtype == torch.float32
    scale = float(ref.float().abs().max())
    err = max_diff(ref.float(), out.float()) / scale
    s_err = max_diff(s_ref, s_fin) / float(s_ref.abs().max())
    print(f"wkv6 {case} {dtype}: max|kernel - twin| / max|out| {err:.3e}, "
          f"state {s_err:.3e}")
    assert err <= WKV_TOL[dtype]
    assert s_err <= 2e-5


@pytest.mark.cuda
def test_wkv6_raises_on_head_sizes_it_was_not_built_for(cuda):
    """Heads of 24 and 1025, which the kernel is not built for, run padded
    to 32 and to 1088 (past the largest cluster's 1024 rows: 2 clusters a
    problem and the add of their parts, 3 launches) and agree with the
    twin (bf16: one rounding step of the largest |out|, the state 2e-5)."""
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
    x = torch.tensor(rng.standard_normal((3, 1, 32, 2, 1025)),
                     dtype=torch.float32, device=cuda).bfloat16()
    w = torch.tensor(_decay(rng, (1, 32, 2, 1025)), dtype=torch.float32,
                     device=cuda)
    u = torch.tensor(0.1 * rng.standard_normal((2, 1025)),
                     dtype=torch.float32, device=cuda)
    s0 = torch.zeros((1, 2, 1025, 1025), device=cuda)
    n0 = wops.wkv6_cuda.launches
    out, s_fin = wops.wkv6(*x, w, u, s0)
    assert wops.wkv6_cuda.launches == n0 + 3
    assert out.shape == x[0].shape and s_fin.shape == s0.shape
    ref, s_ref = wops.wkv6_plain(*x, w, u, s0)
    torch.cuda.synchronize()
    assert max_diff(ref.float(), out.float()) \
        <= 2 ** -7 * float(ref.float().abs().max())
    assert max_diff(s_ref, s_fin) <= 2e-5 * float(s_ref.abs().max())


@pytest.mark.cuda
def test_flash_raises_on_head_dims_it_was_not_built_for(cuda):
    """Head dims of 48 and 257, which the kernels are not built for, run
    padded to 64 and to 320 (the column-split kernels) on the kernel of
    their dtype, one launch each, and agree with the twin (float32 2e-5,
    bfloat16 3e-2, float16 4e-3, as above)."""
    def counts():
        return tuple(getattr(fops, w).launches
                     for w in FLASH_WRAPPERS.values())

    rng = np.random.default_rng(48)
    for dh in (48, 257):
        for name, (tol, _) in FLASH_TOL.items():
            dt = getattr(torch, name)
            q = torch.tensor(rng.standard_normal((1, 128, 2, dh)),
                             dtype=torch.float32, device=cuda).to(dt)
            n0 = counts()
            out = fops.flash_attention(q, q, q)
            assert sum(counts()) == sum(n0) + 1
            ref = fops.flash_attention_plain(q, q, q)
            torch.cuda.synchronize()
            assert out.shape == q.shape and out.dtype == dt
            assert max_diff(ref.float(), out.float()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "rwkv6-3b",
                                  "phi3.5-moe-42b-a6.6b", "hymba-1.5b",
                                  "seamless-m4t-large-v2", "qwen2-vl-2b"])
def test_lm_forward_on_card(cuda, name):
    """forward_train of the reduced config (float32, 2 layers; phi4-mini
    with 2 KV heads for the GQA mapping; hymba's attention branch with its
    window of 64 over 128 tokens; seamless-m4t with 16 frames through its
    encoder, qwen2-vl with 32 patches and M-RoPE) on the card: backend
    "pallas" launches its kernel once per decoder layer (WKV6: its two
    passes; the encoder none) and agrees with "reference" to 2e-5 on the
    O(1) logits (float32, another summation order)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = get_config(name).reduced()
    if cfg.attention_kind == "gqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    params = model.init_params(cfg, seed=0, device=cuda)
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)), device=cuda)
    fe = _frontend_embeds(cfg, 128, cuda)
    wrapper, per_layer = ((fops.flash_attention_fp32_cuda, 1)
                          if cfg.attention_kind in ("gqa", "hybrid")
                          else (wops.wkv6_cuda, 2))
    n0 = wrapper.launches
    out, _ = model.forward_train(cfg, params, tokens, fe, backend="pallas")
    assert wrapper.launches - n0 == per_layer * cfg.num_layers
    ref, _ = model.forward_train(cfg, params, tokens, fe,
                                 backend="reference")
    torch.cuda.synchronize()
    err = max_diff(ref, out)
    print(f"forward_train {name} reduced: max|pallas - reference| {err:.3e}")
    assert err <= 2e-5


def _frontend_embeds(cfg, seq, device):
    """A frontend config's embeddings for a prompt of ``seq`` tokens, N(0,
    1) from a seed; None without a frontend."""
    if not cfg.frontend:
        return None
    from repro_torch.models import frontend
    return torch.tensor(np.random.default_rng(2).standard_normal(
        (2, frontend.num_frontend_tokens(cfg, seq),
         frontend.frontend_dim(cfg))), dtype=torch.float32, device=device)


@pytest.mark.cuda
def test_deepseek_forward_on_card(cuda):
    """forward_train of the reduced deepseek-v3 (float32, 1 dense and 1 MoE
    layer, MLA, the MTP head) on the card against the CPU: the logits
    within 2e-5 (the CPU parity tests' tolerance against the reference)
    and the aux (the router's loss and the MTP term) within 1e-5; no kernel
    launches on either backend (MLA and the experts run none), and backend
    "pallas" gives what "reference" gives."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = get_config("deepseek-v3-671b").reduced()
    params = model.init_params(cfg, seed=0, device="cpu")

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}

    pc = to(params)
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    wrappers = (fops.flash_attention_bf16_cuda, fops.flash_attention_fp32_cuda,
                wops.wkv6_cuda, tops.rb_sor_slabs_packed_cuda,
                tops.rb_sor_slabs_cuda, aops.fused_interval_cuda)
    n0 = [w.launches for w in wrappers]
    out, aux = model.forward_train(cfg, pc, tokens.to(cuda),
                                   backend="pallas")
    ref, ref_aux = model.forward_train(cfg, pc, tokens.to(cuda))
    assert [w.launches for w in wrappers] == n0
    cpu, cpu_aux = model.forward_train(cfg, params, tokens)
    torch.cuda.synchronize()
    err = max_diff(cpu, out.cpu())
    print(f"forward_train deepseek-v3 reduced: max|card - cpu| {err:.3e}, "
          f"aux {float(aux):.6f} vs {float(cpu_aux):.6f}")
    assert err <= 2e-5 and max_diff(ref, out) <= 2e-5
    assert abs(float(aux) - float(cpu_aux)) <= 1e-5
    assert abs(float(ref_aux) - float(aux)) <= 1e-5


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


# ---------------------------------------------------------------------------
# the language model's serving path on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,changes", [
    ("phi4-mini-3.8b", {"num_kv_heads": 2}), ("rwkv6-3b", {}),
    ("qwen1.5-32b", {}), ("llama3-405b", {"kv_cache_dtype": "float8_e4m3fn"}),
    ("phi3.5-moe-42b-a6.6b", {}), ("hymba-1.5b", {}),
    ("deepseek-v3-671b", {}), ("seamless-m4t-large-v2", {}),
    ("qwen2-vl-2b", {})])
def test_decode_on_the_card_matches_the_cpu(cuda, name, changes):
    """``prefill`` of 64 tokens, then 4 ``decode_step``s from it and 4 from
    ``init_cache`` (float8 for llama3 here), of a reduced float32 config on
    the card against the same calls on the CPU (TF32 off): logits within
    2e-5 (the CPU parity tests' tolerance against the reference), every
    cache leaf within 2e-5 of its largest value (hymba's Mamba conv and
    SSM states and deepseek-v3's MLA latent and rope key among them; its
    decode runs the absorbed form; seamless-m4t's cross K / V of the
    prompt's 8 frames, its decode's sinusoidal position read at a device
    position), a float8 leaf within one e4m3 step (2^-3 of
    the value); the position goes in as a CUDA tensor on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    params = model.init_params(cfg, seed=0, device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    pc = to(params, cuda)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 64)))
    steps = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 4)))

    def hold(a, b, what):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        f8 = a.dtype == torch.float8_e4m3fn
        a, b = a.float(), b.cpu().float()
        if f8:
            assert bool(((a - b).abs() <= 0.125 * a.abs()).all()), what
            return
        scale = max(float(a.abs().max()), 1.0)
        assert max_diff(a, b) <= 2e-5 * scale, (what, max_diff(a, b))

    for start in ("prefill", "init_cache"):
        if start == "prefill":
            fe = _frontend_embeds(cfg, 64, "cpu")
            l_cpu, c_cpu = model.prefill(cfg, params, toks, cache_len=68,
                                         frontend_embeds=fe)
            l_gpu, c_gpu = model.prefill(
                cfg, pc, toks.to(cuda), cache_len=68,
                frontend_embeds=None if fe is None else fe.to(cuda))
            hold(l_cpu, l_gpu, "prefill logits")
            pos0 = 64
        else:
            c_cpu = model.init_cache(cfg, 2, 8, device="cpu")
            c_gpu = model.init_cache(cfg, 2, 8, device=cuda)
            pos0 = 0
        for t in range(4):
            tok = steps[:, t:t + 1]
            l_cpu, _ = model.decode_step(cfg, params, c_cpu, tok, pos0 + t)
            l_gpu, _ = model.decode_step(
                cfg, pc, c_gpu, tok.to(cuda),
                torch.tensor(pos0 + t, device=cuda))
            hold(l_cpu, l_gpu, f"{start} decode {t} logits")
            for k in c_cpu:
                hold(c_cpu[k], c_gpu[k], f"{start} decode {t} {k}")


# ---------------------------------------------------------------------------
# the mixture of experts' dispatch on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_moe_dispatch_on_the_card_matches_the_cpu(cuda, cf):
    """The reduced phi3.5's MoE layer (float32, 4 experts, top 2), T 2 x 64,
    at capacity factors 8.0 (dropless), 1.0 and 0.5: for the same router
    output the card's sort order, expert rows and kept set equal the
    CPU's (the stable sort), the router's experts equal, and the
    dispatch's O(1) outputs within 1e-5 (float32 products of another
    summation order) and its aux within 1e-6."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    p = moe.init_moe(cfg, torch.Generator().manual_seed(5))
    pc = {k: v.to(cuda) for k, v in p.items()}
    x = torch.tensor(_rand((2, 64, cfg.d_model), 6))
    C = moe._capacity(cfg, 128)
    _, idx_cpu, _ = moe.router(cfg, p, x.reshape(128, -1))
    _, idx_gpu, _ = moe.router(cfg, pc, x.to(cuda).reshape(128, -1))
    assert torch.equal(idx_cpu, idx_gpu.cpu())
    for a, b in zip(moe.dispatch_plan(cfg, idx_cpu, C),
                    moe.dispatch_plan(cfg, idx_cpu.to(cuda), C)):
        assert torch.equal(a, b.cpu())
    out_cpu, aux_cpu = moe._moe_dispatch(cfg, p, x)
    out_gpu, aux_gpu = moe._moe_dispatch(cfg, pc, x.to(cuda))
    assert max_diff(out_cpu, out_gpu.cpu()) <= 1e-5
    assert abs(float(aux_cpu) - float(aux_gpu)) <= 1e-6


# ---------------------------------------------------------------------------
# the Mamba selective SSM on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S,state", [(1, True), (200, False), (256, True)])
def test_apply_mamba_on_the_card_matches_the_cpu(cuda, S, state):
    """hymba's reduced Mamba branch (float32, d_inner 256, n 8) on the
    card against the CPU, from zero and carried conv / SSM states: the
    output within 1e-5 of its RMS and the SSM state within 1e-6 absolute
    (O(1) states), the tolerances the CPU holds against the reference
    (the card's exp and the doubling scan's products round a few ulp
    apart); the two-level scan against its step-by-step oracle on the
    card likewise."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    cfg = get_config("hymba-1.5b").reduced()
    p = ssm.init_mamba(cfg, torch.Generator().manual_seed(2), d_inner=256)
    pc = {k: v.to(cuda) for k, v in p.items()}
    x = torch.tensor(_rand((2, S, cfg.d_model), S))
    cs = torch.tensor(_rand((2, 3, 256), 1)) if state else None
    hs = torch.tensor(_rand((2, 256, cfg.ssm.state_size), 2)) if state \
        else None
    out_cpu = ssm.apply_mamba(cfg, p, x, cs, hs)
    out_gpu = ssm.apply_mamba(cfg, pc, x.to(cuda),
                              None if cs is None else cs.to(cuda),
                              None if hs is None else hs.to(cuda))
    a, b = out_cpu[0], out_gpu[0].cpu()
    rel = float((a - b).square().mean().sqrt() / a.square().mean().sqrt())
    print(f"apply_mamba S={S}: rel-RMS {rel:.3e}, state "
          f"{max_diff(out_cpu[2], out_gpu[2].cpu()):.3e}")
    assert rel <= 1e-5
    assert max_diff(out_cpu[1], out_gpu[1].cpu()) <= 2e-5
    assert max_diff(out_cpu[2], out_gpu[2].cpu()) <= 1e-6
    dA, dBx, C, _, _, _ = ssm.mamba_discretize(cfg, pc, x.to(cuda))
    h0 = torch.zeros((2, 256, cfg.ssm.state_size), device=cuda)
    y, h = ssm.mamba_scan(dA, dBx, C, h0)
    ry, rh = ssm.mamba_scan_sequential(dA, dBx, C, h0)
    assert max_diff(ry, y) <= 1e-6 * float(ry.abs().max())
    assert max_diff(rh, h) <= 1e-6 * float(rh.abs().max())
