"""The resident kernels' plan on the CPU (kernels/cluster.py
resident_plan, resident_shape): the groups a launch holds from the card's
active-cluster count, the choice of G and C, the block's thread rows side
by side over a band in shared memory, and the workspace's mirror slots.
The kernels run only on the card (tests/test_torch_cuda.py)."""
import pytest

from repro_torch.cfd import grid as tgrid
from repro_torch.kernels import cluster as kcluster
from repro_torch.kernels.actuation import ops as aops
from repro_torch.kernels.poisson import ops as pops

N_SM = 132
# the clusters an H100 80GB HBM3 holds at once (PERF.md §6): 7 of 16
# blocks, 15 of 8, 30 of 4 and 66 of 2
H100 = (7, 15, 30, 66)


def _plan(res, n_env, active, **kw):
    """The fused plan at res ``res`` on a card that holds ``active`` = (of
    16, of 8, of 4, of 2) clusters at once."""
    held = dict(zip((16, 8, 4, 2), active))
    return aops.plan_launch(tgrid.GridConfig(res=res), n_env, N_SM,
                            held.get, lambda g: 132, **kw)


@pytest.mark.parametrize("active,n_env,want", [
    # (clusters of 16, 8, 4, 2 held at once, envs) -> (C, groups a launch,
    # launches) at res 48, whose band fits one block only at G 32
    (H100, 1, (16, 1, 1)), (H100, 3, (16, 3, 1)), (H100, 4, (2, 4, 1)),
    (H100, 6, (16, 3, 2)), (H100, 9, (16, 3, 3)), (H100, 12, (2, 4, 3)),
    ((8, 16, 32, 66), 4, (16, 4, 1)), ((2, 16, 30, 66), 4, (8, 4, 1)),
    ((0, 4, 8, 10), 4, (8, 1, 4)), ((3, 8, 20, 30), 5, (8, 2, 3)),
    ((0, 0, 0, 33), 4, (2, 2, 2)), ((1, 3, 7, 15), 2, (16, 0, 0)),
])
def test_groups_a_launch_follow_active_clusters(active, n_env, want):
    """A launch holds no more groups than the card holds K = G / C clusters
    of C at once; the C of the fewest launches is taken, the larger C
    (fewer cluster edges) on a tie; a card that holds no whole group
    raises."""
    c, per, launches = want
    if not per:
        with pytest.raises(ValueError, match="too few clusters"):
            _plan(48, n_env, active)
        return
    plan = _plan(48, n_env, active)
    assert (plan.kernel, plan.size, plan.cluster, plan.per_launch,
            plan.launches) == ("resident", 32, c, per, launches)


@pytest.mark.parametrize("n_env,want", [(1, (32, 16, 1)), (4, (24, 8, 4)),
                                        (5, (24, 8, 5)), (6, (32, 16, 3)),
                                        (10, (24, 8, 5))])
def test_group_size_of_fewest_launches_then_largest_cluster(n_env, want):
    """Res 71's slab fits one block at G 24 and 32: of the (G, C) of the
    fewest launches on the H100's counts, the largest C, then the largest
    G: 3 clusters of 8 (5 groups a launch) where 2 of 16 (3 groups) need
    more launches."""
    held = dict(zip((16, 8, 4, 2), H100))
    plan = pops.plan_launch(292, 781, 1, n_env, N_SM, held.get,
                            lambda g: 132)
    g, c, per = want
    assert (plan.kernel, plan.size, plan.cluster) == ("resident", g, c)
    assert plan.per_launch == min(n_env, per)
    assert plan.launches == -(-n_env // per)


@pytest.mark.parametrize("w,rows", [(528, 7), (781, 13), (781, 10),
                                    (539, 17), (440, 6), (176, 5), (1045, 13),
                                    (24, 3)])
def test_resident_block_shape_puts_thread_rows_side_by_side(w, rows):
    """The resident block's lanes span a row in a multiple of 32, its
    thread rows stand side by side over the band, at most 1024 threads,
    and no shape of that kind walks fewer points a thread in sequence."""
    threads, tx = kcluster.resident_shape(w, rows)
    ty = threads // tx
    assert tx % 32 == 0 and threads <= 1024 and ty >= 1
    assert ty == min(rows, 1024 // tx)
    steps = -(-rows // ty) * -(-w // tx)
    for other in range(32, 1025, 32):
        oty = max(1, min(rows, 1024 // other))
        assert steps <= -(-rows // oty) * -(-w // other)
    # the one-row shape of the global-memory kernel is never better
    g_threads, g_tx = kcluster.block_shape(w, rows)
    assert steps <= -(-rows // (g_threads // g_tx)) * -(-w // g_tx)


def test_res_48_band_walks_in_one_pass_of_thread_rows():
    """At res 48 (G 32: 7 rows of 528 packed columns) the resident block
    takes 7 thread rows of 128 lanes: 5 points a thread in sequence, where
    the global-memory kernel's one row of 544 lanes walks 7; its predictor,
    whose partial sums follow the layout, keeps the global-memory kernel's
    544 threads, so the two kernels add in one order."""
    cfg = tgrid.GridConfig(res=48)
    assert aops.resident_launch_shape(cfg, 32) == (7, 896, 128, 544, 544)
    assert aops.global_shape(cfg, 32) == (544, 544)
    # a band wider than 1024 lanes: both layouts take 1024 threads
    _, threads, _, pred_threads, pred_tx = aops.resident_launch_shape(
        tgrid.GridConfig(res=52), 32)
    assert (threads, pred_threads, pred_tx) == (
        max(threads, pred_threads), *aops.global_shape(
            tgrid.GridConfig(res=52), 32))


@pytest.mark.parametrize("group,cluster,slots,width,want", [
    (32, 16, 11, 1057, 1 * 2 * 11 * 1088),
    (32, 8, 11, 1057, 3 * 2 * 11 * 1088),
    (24, 8, 8, 781, 2 * 2 * 8 * 800), (16, 8, 8, 32, 1 * 2 * 8 * 32),
])
def test_mirror_slots(group, cluster, slots, width, want):
    """One group's mirror slots: K - 1 cluster edges, two directions,
    ``slots`` slots a direction (a row of tagged words takes two), each
    rounded up to 32 floats (128-byte lines)."""
    assert kcluster.mirror_floats(group, cluster, slots, width) == want
    assert aops.EDGE_SLOTS == 2 * 4 + 3 and pops.EDGE_SLOTS == 2 * 4


def test_resident_workspace_holds_sums_flags_and_mirrors_only():
    """The resident kernels' workspace is the partial sums, flags and
    mirror slots (the SOR's: the slots alone): at res 48 (3 envs of G 32 in
    clusters of 16) 301,056 bytes a launch, where the global-memory kernel
    keeps every field of 4 envs (20.2 MB)."""
    cfg = tgrid.GridConfig(res=48)
    plan = _plan(48, 3, H100)
    assert plan.workspace_bytes == 3 * 4 * (32 * 4 + 32 * 32 + 2 * 11 * 1088)
    assert plan.workspace_bytes == aops.resident_workspace_bytes(
        cfg.ny, cfg.nx, 32, 16, 3) == 301_056
    # 4 envs in clusters of 2: 15 cluster edges an env
    assert _plan(48, 4, H100).workspace_bytes == 4 * 4 * (
        32 * 4 + 32 * 32 + 15 * 2 * 11 * 1088)
    forced = _plan(48, 4, H100, force_global=True)
    assert forced.workspace_bytes > 60 * plan.workspace_bytes
    assert pops.resident_workspace_bytes(292, 781, 24, 8, 4) == 4 * 4 * (
        2 * 2 * 8 * 800)
