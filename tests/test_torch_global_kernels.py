"""The routing and launch plan of the CFD kernels past one cluster, on the
CPU: which kernel serves each grid (the cluster kernel where a 16-block
cluster holds it, the resident kernel where a group of K clusters of C
blocks does, the global-memory kernel everywhere else), the resident and
global-memory kernels' blocks an env (G), clusters, workspace and
launches, and the refusals that name their numbers; then the port's fused
interval on two such grids against the reference's jnp tier.  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""
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
SOR_PAST_CLUSTER_FIRST = (71, 73, 77, 79, 83, 85, 89, 91, 95, 97, 98, 101,
                          103)
# of those, the 23 whose slab no resident group of up to 32 blocks holds
SOR_GLOBAL = (95, 97, 101, 103, 107, 109, 113, 115, 119, 121, 127, 131, 133,
              137, 139, 142, 143, 146, 149, 151, 154, 157, 158)
# the resident kernels' (C, K): clusters of C blocks, K >= 2 clusters a
# group of 24 or 32 blocks
RESIDENT_CK = tuple((c, g // c) for g in (24, 32) for c in (16, 8, 4, 2)
                    if g % c == 0 and g // c >= 2)


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


def _fused_smem(ny, nx, g, n_bodies):
    """One block's shared memory at G blocks an env, written out field by
    field: the largest band of u, v (halo rows and the wall row), u_pen,
    v_pen, red, black, rhs_r, rhs_b, then the mbarriers, the partial sums
    and the reduction's slots."""
    r, w = -(-ny // g), nx // 2
    extra = 4 + 4 + 128 if not n_bodies else 4 + 8 + 232
    return 4 * ((r + 2) * (nx + 1) + (r + 3) * nx + r * nx + (r + 1) * nx
                + 2 * (r + 2) * w + 2 * r * w + extra)


def _slab_smem(ny, bxp, g):
    """One block of a slab kernel at G blocks a group: red and black with a
    halo row each side, rhs_r and rhs_b, four ghost columns, two
    mbarriers."""
    r = -(-ny // g)
    return 4 * (4 + 2 * (r + 2) * bxp + 2 * r * bxp + 4 * r)


def _resident_expected(fits, n_groups, active=ACTIVE):
    """(G, C, groups a launch, launches) as the resident plan should pick
    them: the fewest launches, then the largest C, then the largest G,
    each launch no more groups than the card holds K clusters of C."""
    best = None
    for g in fits:
        for c, k in RESIDENT_CK:
            if c * k != g:
                continue
            per = min(n_groups, active[c] // k)
            if per:
                key = (-(-n_groups // per), -c, -g)
                best = min(best or (key, g, c, per), (key, g, c, per))
    (launches, _, _), g, c, per = best
    return g, c, per, launches


def _mirror_bytes(g, c, slots, width):
    """One group's mirror slots: K - 1 cluster edges, two directions,
    ``slots`` rows of ``width`` floats padded to 32 (a row of tagged words
    taking two)."""
    return 4 * (g // c - 1) * 2 * slots * 32 * -(-width // 32)


def _global_g(ny, n_groups):
    """G as the plan should pick it: a block an SM while the groups leave
    SMs to spare, 32 at most, one row a block at least."""
    return max(1, min(32, ny, N_SM // n_groups))


@pytest.mark.parametrize("n_env", ENVS)
@pytest.mark.parametrize("n_bodies", [0, 3])
def test_fused_routing_and_plan_every_grid(n_bodies, n_env):
    """Every even-width grid from res 8 to 160: the cluster kernel on
    exactly the grids it served before (res <= 38, one launch); the
    resident kernel where one env's band fits one block at G = K C <= 32
    (res 39 to 52), at the G and C of the fewest launches, with its
    partial sums, flags and mirror slots; the global-memory kernel on
    every other grid, with its G, its workspace and its launches (more
    than one only where the envs' blocks outnumber what the card
    holds)."""
    routed = {"cluster": [], "resident": [], "global": []}
    for res in RES:
        cfg = tgrid.GridConfig(res=res)
        assert cfg.nx % 2 == 0
        plan = aops.plan_launch(cfg, n_env, N_SM, ACTIVE.get,
                                lambda g: RESIDENT, n_bodies)
        routed[plan.kernel].append(res)
        assert plan.kernel == aops.check_kernel_grid(cfg, n_bodies)
        if res <= 38:
            assert plan.kernel == "cluster", res
            assert plan.size == plan.cluster == aops.choose_cluster(
                cfg.ny, cfg.nx, n_env, N_SM, ACTIVE, aops.SMEM_PER_BLOCK,
                n_bodies)
            assert (plan.launches, plan.workspace_bytes) == (1, 0)
            continue
        fits = [g for g in (24, 32)
                if _fused_smem(cfg.ny, cfg.nx, g, n_bodies)
                <= aops.SMEM_PER_BLOCK]
        if fits:
            assert plan.kernel == "resident", res
            g, c, per, launches = _resident_expected(fits, n_env)
            assert (plan.size, plan.cluster, plan.per_launch,
                    plan.launches) == (g, c, per, launches), res
            # partial sums and flags; the SOR's red and black rows by
            # parity as tagged words, u, v and v_pen as floats
            assert plan.workspace_bytes == per * (
                4 * g * ((8 if n_bodies else 4) + 32)
                + _mirror_bytes(g, c, 2 * 4 + 3, cfg.nx + 1))
            continue
        assert plan.kernel == "global", res
        g = _global_g(cfg.ny, n_env)
        per = min(n_env, RESIDENT // g)
        assert (plan.size, plan.per_launch) == (g, per), res
        assert plan.launches == -(-n_env // per)
        assert plan.workspace_bytes == per * _fused_env_bytes(
            cfg.ny, cfg.nx, g, n_bodies)
    assert routed["resident"] == list(range(39, 53))
    assert routed["global"] == list(range(53, 161))
    # past residency: 200 envs of one block each, in launches of 132
    plan = aops.plan_launch(tgrid.GridConfig(res=56), 200, N_SM, ACTIVE.get,
                            lambda g: RESIDENT, n_bodies)
    assert (plan.size, plan.per_launch, plan.launches) == (1, 132, 2)
    # res 48 holds a band only at G 32: the fake card's 7 clusters of 16,
    # 15 of 8 and 30 of 4 hold 3 such groups at once, its 66 of 2 hold 4
    plan = aops.plan_launch(tgrid.GridConfig(res=48), 200, N_SM, ACTIVE.get,
                            lambda g: RESIDENT, n_bodies)
    assert (plan.kernel, plan.size, plan.cluster, plan.per_launch,
            plan.launches) == ("resident", 32, 2, 4, 50)


@pytest.mark.parametrize("n_env", ENVS)
@pytest.mark.parametrize("full", [False, True])
def test_sor_routing_and_plan_every_grid(full, n_env):
    """Every even-width grid from res 8 to 160 at the reference's slab
    count, packed planes and the full grid alike: the cluster kernel where
    a 16-block cluster holds a slab; of the 48 grids it does not (res 71,
    73, 77, ...), the resident kernel on the 25 whose slab a group of G = K
    C <= 32 blocks holds, and the global-memory kernel on the other 23 (res
    95, 97, 101, ...); one group per (env, slab), with its G, its
    clusters, its workspace and its launches."""
    routed_past, routed_global = [], []
    for res in RES:
        cfg = tgrid.GridConfig(res=res)
        w, nslabs = cfg.nx // 2, pops._pick_nslabs(cfg.nx)
        bxp = w // nslabs
        if full:
            assert pops.check_grid(cfg.ny, cfg.nx, nslabs) == 2 * bxp
        plan = pops.plan_launch(cfg.ny, w, nslabs, n_env, N_SM, ACTIVE.get,
                                lambda g: RESIDENT)
        groups = n_env * nslabs
        assert plan.kernel == pops.slab_kernel(cfg.ny, bxp)
        if plan.kernel == "cluster":
            assert plan.size == pops.choose_cluster(cfg.ny, bxp, groups,
                                                    N_SM, ACTIVE)
            assert (plan.launches, plan.workspace_bytes) == (1, 0)
            continue
        routed_past.append(res)
        fits = [g for g in (24, 32)
                if _slab_smem(cfg.ny, bxp, g) <= pops.SMEM_PER_BLOCK]
        if fits:
            assert plan.kernel == "resident", res
            g, c, per, launches = _resident_expected(fits, groups)
            assert (plan.size, plan.cluster, plan.per_launch,
                    plan.launches) == (g, c, per, launches), res
            # red and black rows by parity as tagged words, no flags
            assert plan.workspace_bytes == per * _mirror_bytes(
                g, c, 2 * 4, bxp)
            continue
        assert plan.kernel == "global", res
        routed_global.append(res)
        g = _global_g(cfg.ny, groups)
        per = min(groups, RESIDENT // g)
        assert (plan.size, plan.per_launch) == (g, per), res
        assert plan.launches == -(-groups // per)
        assert plan.workspace_bytes == per * _slab_bytes(cfg.ny, bxp, g)
    assert tuple(routed_past[:len(SOR_PAST_CLUSTER_FIRST)]) == \
        SOR_PAST_CLUSTER_FIRST
    assert len(routed_past) == 48 and min(routed_past) == 71
    assert tuple(routed_global) == SOR_GLOBAL


def test_forced_global_kernel_on_a_cluster_grid():
    """``force_global`` takes the global-memory kernel where a cluster
    holds the grid (how the card holds the two against each other), at
    the cluster kernel's size when that is given, and where a resident
    group does, at the resident kernel's G."""
    cfg = tgrid.GridConfig(res=38)
    plan = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT)
    assert (plan.kernel, plan.size) == ("cluster", 16)
    forced = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT,
                              cluster=16, force_global=True)
    assert (forced.kernel, forced.size, forced.launches) == ("global", 16, 1)
    forced = pops.plan_launch(288, 770, 2, 2, N_SM, ACTIVE.get,
                              lambda g: RESIDENT, force_global=True)
    assert (forced.kernel, forced.size) == ("global", 32)
    cfg = tgrid.GridConfig(res=48)
    plan = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT)
    assert (plan.kernel, plan.size, plan.cluster) == ("resident", 32, 2)
    forced = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT,
                              cluster=plan.size, force_global=True)
    assert (forced.kernel, forced.size, forced.cluster, forced.launches) == (
        "global", 32, 0, 1)
    plan = pops.plan_launch(292, 781, 1, 4, N_SM, ACTIVE.get,
                            lambda g: RESIDENT)
    assert (plan.kernel, plan.size, plan.cluster) == ("resident", 24, 8)
    forced = pops.plan_launch(292, 781, 1, 4, N_SM, ACTIVE.get,
                              lambda g: RESIDENT, cluster=24,
                              force_global=True)
    assert (forced.kernel, forced.size) == ("global", 24)


def test_pinned_group_past_residency_runs_in_launches():
    """A pinned G (a fleet's whole-batch choice) over a batch whose blocks
    outnumber the card's: groups run in further launches of whole groups,
    never one group's blocks in waves."""
    cfg = tgrid.GridConfig(res=40)
    plan = aops.plan_launch(cfg, 5, N_SM, ACTIVE.get, lambda g: RESIDENT,
                            cluster=32, force_global=True)
    assert (plan.size, plan.per_launch, plan.launches) == (32, 4, 2)
    assert plan.workspace_bytes == 4 * _fused_env_bytes(cfg.ny, cfg.nx, 32, 0)
    plan = pops.plan_launch(292, 781, 1, 9, N_SM, ACTIVE.get,
                            lambda g: 2 * RESIDENT, cluster=32,
                            force_global=True)
    assert (plan.per_launch, plan.launches) == (8, 2)
    # the resident kernel at a pinned G: the fake card holds 3 groups of 2
    # clusters of 16 (or of 4 of 8, 8 of 4) at once, 4 of 16 of 2: 2
    # launches either way, and the larger clusters
    plan = aops.plan_launch(cfg, 5, N_SM, ACTIVE.get, lambda g: RESIDENT,
                            cluster=32)
    assert (plan.kernel, plan.size, plan.cluster, plan.per_launch,
            plan.launches) == ("resident", 32, 16, 3, 2)
    plan = pops.plan_launch(292, 781, 1, 9, N_SM, ACTIVE.get,
                            lambda g: RESIDENT, cluster=32)
    assert (plan.kernel, plan.per_launch, plan.launches) == ("resident", 3, 3)


def test_calls_the_card_cannot_hold_raise_with_their_numbers():
    """A group the card cannot hold at once, and a G outside 1..min(32,
    ny), raise before any launch, naming the numbers."""
    cfg = tgrid.GridConfig(res=48)
    with pytest.raises(ValueError, match=r"needs the 32 blocks of a group "
                       r"resident at once, the card holds 16 blocks"):
        aops.plan_launch(cfg, 1, N_SM, ACTIVE.get, lambda g: 16,
                         force_global=True)
    with pytest.raises(ValueError, match=r"a group of 33 blocks; the global-"
                       r"memory kernel splits 198 rows over 1 to 32 blocks"):
        aops.plan_launch(cfg, 1, N_SM, ACTIVE.get, lambda g: RESIDENT,
                         cluster=33, force_global=True)
    with pytest.raises(ValueError, match=r"\(292, 781\) slabs: the global-"
                       r"memory kernel needs the 24 blocks"):
        pops.plan_launch(292, 781, 1, 1, N_SM, ACTIVE.get, lambda g: 20,
                         cluster=24, force_global=True)
    # the resident kernel: a G whose band does not fit one block, and a
    # card that holds fewer clusters at once than one group has
    with pytest.raises(ValueError, match=r"a group of 24 blocks cannot hold "
                       r"it in shared memory; resident group sizes that fit: "
                       r"\[32\]"):
        aops.plan_launch(cfg, 1, N_SM, ACTIVE.get, lambda g: RESIDENT,
                         cluster=24)
    with pytest.raises(ValueError, match=r"\(292, 781\) slabs: the card "
                       r"holds too few clusters at once for one resident "
                       r"group of any of the sizes \[24, 32\] \(clusters "
                       r"of 8: 2 at G 24, 4: 5 at G 24, 2: 11 at G 24, 16: 1 "
                       r"at G 32, 8: 3 at G 32, 4: 7 at G 32, 2: 15 at G "
                       r"32\)"):
        few = {16: 1, 8: 2, 4: 5, 2: 11}
        pops.plan_launch(292, 781, 1, 1, N_SM, lambda c: few[c],
                         lambda g: RESIDENT,
                         resident_active=lambda c, g: few[c] + (g == 32)
                         * {16: 0, 8: 1, 4: 2, 2: 4}[c])
    with pytest.raises(ValueError, match="splits 6 rows over 1 to 6"):
        pops.plan_launch(6, 40, 1, 1, N_SM, ACTIVE.get, lambda g: RESIDENT,
                         cluster=7, force_global=True)
    with pytest.raises(ValueError, match="does not split into 3 slabs"):
        pops.plan_launch(292, 781, 3, 1, N_SM, ACTIVE.get,
                         lambda g: RESIDENT)


def test_global_group_partition_is_the_band_partition():
    """The global-memory and resident kernels split rows as the cluster
    kernels do (csrc/grid_sync.cuh band_start: r ny / G), bands within a
    row of each other, at every G a plan picks; a resident block's shared
    memory is the cluster kernel's at its largest band, ceil(ny / G)
    rows."""
    for ny in (160, 198, 292, 394, 656):
        for g in (1, 4, 24, 26, 32):
            starts = kcluster.band_starts(ny, g)
            assert starts == tuple(r * ny // g for r in range(g + 1))
            sizes = np.diff(starts)
            assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
            assert kcluster.rows_max(starts) == -(-ny // g)
    cfg = tgrid.GridConfig(res=48)
    plan = aops.plan_launch(cfg, 4, N_SM, ACTIVE.get, lambda g: RESIDENT)
    assert aops.smem_bytes(cfg.ny, cfg.nx, plan.size) == _fused_smem(
        cfg.ny, cfg.nx, plan.size, 0) == 211_780


# ---------------------------------------------------------------------------
# the fused interval past one cluster, against the reference
# ---------------------------------------------------------------------------

# u, v are O(1), p O(1-10), C_D O(5), both packages float32; over 2 dt of
# 20 SOR pairs the two differ by where they round (XLA fuses and contracts
# a*b+c, PyTorch rounds op by op): test_torch_solver's tolerances
ATOL_UV, ATOL_P, ATOL_CD = 1e-5, 1e-4, 1e-4


@pytest.mark.parametrize("res", [40, 71])
def test_fused_interval_past_one_cluster_matches_reference(res):
    """Res 40 (the first grids past a cluster, which the resident kernel
    serves on the card; ny 164, nx 880) and res 71 (one (292, 1562) slab,
    the global-memory kernel's): the port's step_interval(backend="fused") on
    the CPU, its plain twin, against the reference's jnp tier, 2 dt at 20
    SOR pairs, from a perturbed impulsive start mixing jets (act_mode 0)
    on the cylinder."""
    cfg_j = jgrid.GridConfig(res=res, poisson_iters=20)
    cfg_t = tgrid.GridConfig(res=res, poisson_iters=20)
    assert aops.check_kernel_grid(cfg_t) == {40: "resident", 71: "global"}[res]
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
