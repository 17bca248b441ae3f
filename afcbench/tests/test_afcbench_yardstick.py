"""The frozen yardstick against the counts PERF.md records."""
import pytest

from afcbench import yardstick
from afcbench.reference.cfd import Grid


@pytest.mark.parametrize("res,n_env,n_bodies,flops,nbytes", [
    (16, 4, 0, 3_331_420_400, 3_370_728),       # cluster <0>
    (16, 4, 3, 3_443_937_200, 4_311_616),       # per-body <3>
    (48, 4, 0, 29_955_195_600, 30_181_336),     # resident, res 48
    (16, 32, 0, 26_651_363_200, 19_087_800),    # cyl_re100.res16.envs32
    (16, 32, 3, 27_551_497_600, 20_051_424),    # pinball_re100.res16.envs32
])
def test_interval_work_pinned(res, n_env, n_bodies, flops, nbytes):
    g = Grid(res=res)
    assert yardstick.interval_work(g.ny, g.nx, g.poisson_iters, n_env, 50,
                                   n_bodies) == (flops, nbytes)


def test_bound_is_the_longer_of_compute_and_memory():
    g = Grid(res=16)
    f, b = yardstick.interval_work(g.ny, g.nx, g.poisson_iters, 4, 50)
    assert yardstick.bound_s(f, b) == pytest.approx(f / 67e12)
    assert yardstick.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_policy_flops_from_the_layer_shapes():
    # one 3 -> 4 -> 2 stack over 5 rows: 2 a b + b per layer, a tanh per
    # hidden unit
    assert yardstick.mlp_forward_flops([3, 4, 2], 5) == 5 * (
        (2 * 3 * 4 + 4) + 4 + (2 * 4 * 2 + 2))
    f = yardstick.policy_flops(149, 1, 512, 2, 32, 100, 10)
    actor = yardstick.mlp_forward_flops([149, 512, 512, 1], 3200)
    critic = yardstick.mlp_forward_flops([149, 512, 512, 1], 3200)
    assert f == actor + yardstick.mlp_forward_flops(
        [149, 512, 512, 1], 3232) + 10 * 3 * (actor + critic)
