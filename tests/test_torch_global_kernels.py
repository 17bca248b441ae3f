"""The routing and launch plan of the CFD kernels past one cluster, on the
CPU: which kernel serves each grid (the cluster kernel where a 16-block
cluster holds it, the global-memory kernel everywhere else), the
global-memory kernel's blocks an env (G), workspace and launches, and the
refusals that name their numbers; then the port's fused interval on two
such grids against the reference's jnp tier.  The kernels themselves run
only on the card (tests/test_torch_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cfd import grid as jgrid
from repro.cfd import solver as jsolver
from repro.kernels.actuation import ops as jops
from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import solver as tsolver
from repro_torch.convert import flow_state_from_numpy
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.poisson import ops as pops
from tests._torch_parity import assert_close

# the fake card of tests/test_torch_cluster.py: 132 SMs, the clusters of
# each size it holds at once; and one block of a global-memory kernel an SM
ACTIVE = {16: 7, 8: 15, 4: 30, 2: 66}
N_SM = 132
RESIDENT = 132
# env counts: one, the training batch, a batch of small groups, and more
# envs than the card holds blocks
ENVS = (1, 4, 32, 200)
RES = range(8, 161)
# the grids whose SOR slab no 16-block cluster holds at the reference's
# slab count, from res 71 to 160: 48 of them, beginning
SOR_GLOBAL_FIRST = (71, 73, 77, 79, 83, 85, 89, 91, 95, 97, 98, 101, 103)


def _fused_env_bytes(ny, nx, group, n_bodies):
    """One env's workspace of the global-memory fused kernel, written out
    field by field: u, v, u_pen, v_pen, red, black, rhs_r, rhs_b, each
    block's partial sums (fx, fy, outflux in 4 slots; 2 NB + 1 in 8) and
    its flag line of 32 words."""
    w = nx // 2
    fields = ((ny + 2) * (nx + 1) + (ny + 3) * nx + ny * nx + (ny + 1) * nx
              + 2 * (ny + 2) * w + 2 * ny * w)
    return 4 * (fields + group * (8 if n_bodies else 4) + group * 32)


def _slab_bytes(ny, bxp, group):
    """One (env, slab)'s workspace of the global-memory SOR kernel: red and
    black with a halo row each side, rhs_r and rhs_b, four ghost columns,
    each block's flag line."""
    return 4 * (2 * (ny + 2) * bxp + 2 * ny * bxp + 4 * ny + group * 32)


def _global_g(ny, n_groups):
    """G as the plan should pick it: a block an SM while the groups leave
    SMs to spare, 32 at most, one row a block at least."""
    return max(1, min(32, ny, N_SM // n_groups))


@pytest.mark.parametrize("n_env", ENVS)
@pytest.mark.parametrize("n_bodies", [0, 3])
def test_fused_routing_and_plan_every_grid(n_bodies, n_env):
    """Every even-width grid from res 8 to 160: the cluster kernel on
    exactly the grids it served before (res <= 38, one launch), the
    global-memory kernel on every other, with its G, its workspace and its
    launches (more than one only where the envs' blocks outnumber what the
    card holds)."""
    for res in RES:
        cfg = tgrid.GridConfig(res=res)
        assert cfg.nx % 2 == 0
        plan = aops.plan_launch(cfg, n_env, N_SM, ACTIVE.get,
                                lambda g: RESIDENT, n_bodies)
        if res <= 38:
            assert plan.kernel == "cluster", res
            assert plan.size == aops.choose_cluster(
                cfg.ny, cfg.nx, n_env, N_SM, ACTIVE, aops.SMEM_PER_BLOCK,
                n_bodies)
            assert (plan.launches, plan.workspace_bytes) == (1, 0)
            continue
        assert plan.kernel == "global", res
        g = _global_g(cfg.ny, n_env)
        per = min(n_env, RESIDENT // g)
        assert (plan.size, plan.per_launch) == (g, per), res
        assert plan.launches == -(-n_env // per)
        assert plan.workspace_bytes == per * _fused_env_bytes(
            cfg.ny, cfg.nx, g, n_bodies)
    # past residency: 200 envs of one block each, in launches of 132
    plan = aops.plan_launch(tgrid.GridConfig(res=48), 200, N_SM, ACTIVE.get,
                            lambda g: RESIDENT, n_bodies)
    assert (plan.size, plan.per_launch, plan.launches) == (1, 132, 2)


@pytest.mark.parametrize("n_env", ENVS)
@pytest.mark.parametrize("full", [False, True])
def test_sor_routing_and_plan_every_grid(full, n_env):
    """Every even-width grid from res 8 to 160 at the reference's slab
    count, packed planes and the full grid alike: the cluster kernel where
    a 16-block cluster holds a slab, the global-memory kernel on the 48
    grids it does not (res 71, 73, 77, ...), one group per (env, slab),
    with its G, its workspace and its launches."""
    routed_global = []
    for res in RES:
        cfg = tgrid.GridConfig(res=res)
        w, nslabs = cfg.nx // 2, pops._pick_nslabs(cfg.nx)
        bxp = w // nslabs
        if full:
            assert pops.check_grid(cfg.ny, cfg.nx, nslabs) == 2 * bxp
        plan = pops.plan_launch(cfg.ny, w, nslabs, n_env, N_SM, ACTIVE.get,
                                lambda g: RESIDENT)
        groups = n_env * nslabs
        if plan.kernel == "cluster":
            assert plan.size == pops.choose_cluster(cfg.ny, bxp, groups,
                                                    N_SM, ACTIVE)
            assert (plan.launches, plan.workspace_bytes) == (1, 0)
            continue
        routed_global.append(res)
        g = _global_g(cfg.ny, groups)
        per = min(groups, RESIDENT // g)
        assert (plan.size, plan.per_launch) == (g, per), res
        assert plan.launches == -(-groups // per)
        assert plan.workspace_bytes == per * _slab_bytes(cfg.ny, bxp, g)
    assert tuple(routed_global[:len(SOR_GLOBAL_FIRST)]) == SOR_GLOBAL_FIRST
    assert len(routed_global) == 48 and min(routed_global) == 71


def test_forced_global_kernel_on_a_cluster_grid():
    """``force_global`` takes the global-memory kernel where a cluster
    holds the grid (how the card holds the two against each other), at
    the cluster kernel's size when that is given."""
    cfg = tgrid.GridConfig(res=38)
    plan = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT)
    assert (plan.kernel, plan.size) == ("cluster", 16)
    forced = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT,
                              cluster=16, force_global=True)
    assert (forced.kernel, forced.size, forced.launches) == ("global", 16, 1)
    forced = pops.plan_launch(288, 770, 2, 2, N_SM, ACTIVE.get,
                              lambda g: RESIDENT, force_global=True)
    assert (forced.kernel, forced.size) == ("global", 32)


def test_pinned_group_past_residency_runs_in_launches():
    """A pinned G (a fleet's whole-batch choice) over a batch whose blocks
    outnumber the card's: groups run in further launches of whole groups,
    never one group's blocks in waves."""
    cfg = tgrid.GridConfig(res=40)
    plan = aops.plan_launch(cfg, 5, N_SM, ACTIVE.get, lambda g: RESIDENT,
                            cluster=32)
    assert (plan.size, plan.per_launch, plan.launches) == (32, 4, 2)
    assert plan.workspace_bytes == 4 * _fused_env_bytes(cfg.ny, cfg.nx, 32, 0)
    plan = pops.plan_launch(292, 781, 1, 9, N_SM, ACTIVE.get,
                            lambda g: 2 * RESIDENT, cluster=32)
    assert (plan.per_launch, plan.launches) == (8, 2)


def test_calls_the_card_cannot_hold_raise_with_their_numbers():
    """A group the card cannot hold at once, and a G outside 1..min(32,
    ny), raise before any launch, naming the numbers."""
    cfg = tgrid.GridConfig(res=48)
    with pytest.raises(ValueError, match=r"needs the 32 blocks of a group "
                       r"resident at once, the card holds 16 blocks"):
        aops.plan_launch(cfg, 1, N_SM, ACTIVE.get, lambda g: 16)
    with pytest.raises(ValueError, match=r"a group of 33 blocks; the global-"
                       r"memory kernel splits 198 rows over 1 to 32 blocks"):
        aops.plan_launch(cfg, 1, N_SM, ACTIVE.get, lambda g: RESIDENT,
                         cluster=33)
    with pytest.raises(ValueError, match=r"\(292, 781\) slabs: the global-"
                       r"memory kernel needs the 24 blocks"):
        pops.plan_launch(292, 781, 1, 1, N_SM, ACTIVE.get, lambda g: 20,
                         cluster=24)
    with pytest.raises(ValueError, match="splits 6 rows over 1 to 6"):
        pops.plan_launch(6, 40, 1, 1, N_SM, ACTIVE.get, lambda g: RESIDENT,
                         cluster=7, force_global=True)
    with pytest.raises(ValueError, match="does not split into 3 slabs"):
        pops.plan_launch(292, 781, 3, 1, N_SM, ACTIVE.get,
                         lambda g: RESIDENT)


def test_global_group_partition_is_the_band_partition():
    """The global-memory kernels split rows as the cluster kernels do
    (csrc/grid_sync.cuh band_start: r ny / G), bands within a row of each
    other, at every G a plan picks."""
    for ny in (160, 198, 292, 394, 656):
        for g in (1, 4, 26, 32):
            starts = kcluster.band_starts(ny, g)
            assert starts == tuple(r * ny // g for r in range(g + 1))
            sizes = np.diff(starts)
            assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1


# ---------------------------------------------------------------------------
# the fused interval past one cluster, against the reference
# ---------------------------------------------------------------------------

# u, v are O(1), p O(1-10), C_D O(5), both packages float32; over 2 dt of
# 20 SOR pairs the two differ by where they round (XLA fuses and contracts
# a*b+c, PyTorch rounds op by op): test_torch_solver's tolerances
ATOL_UV, ATOL_P, ATOL_CD = 1e-5, 1e-4, 1e-4


@pytest.mark.parametrize("res", [40, 71])
def test_fused_interval_past_one_cluster_matches_reference(res):
    """Res 40 (the first grids past a cluster, ny 164, nx 880) and res 71
    (one (292, 1562) slab): the port's step_interval(backend="fused") on
    the CPU, its plain twin, against the reference's jnp tier, 2 dt at 20
    SOR pairs, from a perturbed impulsive start mixing jets (act_mode 0)
    on the cylinder."""
    cfg_j = jgrid.GridConfig(res=res, poisson_iters=20)
    cfg_t = tgrid.GridConfig(res=res, poisson_iters=20)
    assert aops.check_kernel_grid(cfg_t) == "global"
    geom_j, geom_t = jgrid.build_geometry(cfg_j), tgrid.build_geometry(cfg_t)
    rng = np.random.default_rng(res)
    st = [np.asarray(a) + np.float32(0.01) * rng.standard_normal(
        np.shape(a)).astype(np.float32)
        for a in jsolver.init_state(cfg_j, geom_j)]
    ref, outs_j = jax.jit(lambda s: jops.fused_interval(
        cfg_j, jsolver.geom_to_arrays(geom_j), s, jnp.float32(0.4), 2,
        act_mode=jnp.float32(0.0), tier="jnp"))(jsolver.FlowState(*st))
    out, outs_t = tsolver.step_interval(
        cfg_t, tsolver.geom_to_arrays(geom_t, "cpu"),
        flow_state_from_numpy(*st, device="cpu"), 0.4, 2, act_mode=0.0,
        backend="fused")
    assert outs_t.cd.shape == (2,)
    for name, r, o, tol in zip("uvp", ref, out, (ATOL_UV, ATOL_UV, ATOL_P)):
        assert_close(r, o, tol, f"res {res} {name}")
    assert_close(outs_j.cd, outs_t.cd, ATOL_CD, "cd")
    assert_close(outs_j.cl, outs_t.cl, ATOL_CD, "cl")
    assert torch.isfinite(out.p).all()


def test_launch_count_is_read_only_under_a_counter():
    """The wrappers hand ``kernels.counted`` their launch count as a
    function: without a cost counter it is never called, so a call plans
    its launch once; under one it is called once and recorded."""
    from repro_torch import kernels
    from repro_torch.launch import cost_analysis as ca
    calls = []

    def launches():
        calls.append(1)
        return 13

    with kernels.counted("k", lambda: (0, 0), launches):
        pass
    assert calls == []

    def f():
        with kernels.counted("k", lambda: (5, 7), launches):
            pass

    res = ca.analyze(f)
    assert calls == [1]
    assert res["kernels"] == {"k": {"launches": 13, "flops": 5, "bytes": 7}}
