"""Parity of the port's env layer (repro_torch.cfd.probes/scenarios/env)
with the reference (repro, JAX)."""
import jax.numpy as jnp
import jax.scipy.ndimage
import numpy as np
import pytest
import torch

from repro.cfd import env as jenv
from repro.cfd import grid as jgrid
from repro.cfd import probes as jprobes
from repro.cfd import scenarios as jscn
from repro_torch.cfd import env as tenv
from repro_torch.cfd import grid as tgrid
from repro_torch.cfd import probes as tprobes
from repro_torch.cfd import scenarios as tscn
from tests._torch_parity import assert_close, to_np

# A bilinear gather of O(1) values: the same four products summed in the
# same order, so float32 agreement to a few ulp
ATOL_PROBE = 1e-6


def test_probes_at_and_beyond_edges_match_map_coordinates():
    """Coordinates on, between and outside the grid (mode="nearest" clamps
    the indices, the weights still come from the unclamped coordinate)."""
    rng = np.random.default_rng(0)
    ny, nx = 12, 20
    p = rng.standard_normal((ny, nx)).astype(np.float32)
    edge = np.array([[0, 0], [ny - 1, nx - 1], [-0.5, 3.2], [ny - 0.5, 4.0],
                     [5.5, -2.7], [3.3, nx + 1.6], [-3.0, -3.0],
                     [ny + 2.2, nx + 0.1], [2.0, 7.0], [6.25, 11.75]],
                    np.float32)
    inside = rng.uniform([-1, -1], [ny, nx], (40, 2)).astype(np.float32)
    ij = np.concatenate([edge, inside])
    ref = jax.scipy.ndimage.map_coordinates(jnp.asarray(p),
                                            jnp.asarray(ij).T, order=1,
                                            mode="nearest")
    out = tprobes.sample_pressure(torch.tensor(ij), torch.tensor(p))
    assert_close(ref, out, ATOL_PROBE, "probes")
    mask = (rng.uniform(size=len(ij)) > 0.3).astype(np.float32)
    ref_m = jprobes.sample_pressure(ij, jnp.asarray(p), mask)
    out_m = tprobes.sample_pressure(torch.tensor(ij), torch.tensor(p),
                                    torch.tensor(mask))
    assert_close(ref_m, out_m, ATOL_PROBE, "masked probes")


def test_probes_batched_per_env_layouts():
    rng = np.random.default_rng(1)
    p = rng.standard_normal((3, 10, 16)).astype(np.float32)
    ij = rng.uniform(-1, 17, (3, 7, 2)).astype(np.float32)
    out = tprobes.sample_pressure(torch.tensor(ij), torch.tensor(p))
    for i in range(3):
        ref = jprobes.sample_pressure(ij[i], jnp.asarray(p[i]))
        assert_close(ref, out[i], ATOL_PROBE, f"env {i}")


@pytest.mark.parametrize("name", ["ring149", "sparse24", "sparse8",
                                  "pinball", "tandem"])
def test_layouts_match(name):
    assert np.array_equal(jprobes.layout_positions(name),
                          tprobes.layout_positions(name))


def test_scenario_registry_and_params_match():
    assert jscn.list_scenarios() == tscn.list_scenarios()
    grid_j, grid_t = jgrid.GridConfig(res=6), tgrid.GridConfig(res=6)
    names = ["cyl_re100", "cyl_re200_rotary", "cyl_re100_sparse8"]
    ref = jscn.batch_params(names, grid_j, cd0s=[3.0, 3.5, 4.0])
    out = tscn.batch_params(names, grid_t, cd0s=[3.0, 3.5, 4.0],
                           device="cpu")
    for f in jscn.ScenarioParams._fields:
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              to_np(getattr(out, f))), f
    assert tscn.assign_envs(["cyl_re100", "cyl_re200"], 3) == tuple(
        tscn.get_scenario(n) for n in ("cyl_re100", "cyl_re200",
                                       "cyl_re100"))
    with pytest.raises(ValueError, match="n_envs"):
        tscn.assign_envs(names, 2)
    with pytest.raises(ValueError, match="no cd0"):
        tscn.scenario_params(tscn.get_scenario("cyl_re100"), grid_t,
                             device="cpu")


ENV_KW = dict(steps_per_action=4, actions_per_episode=2, warmup_time=0.2)


@pytest.fixture(scope="module")
def env_pair():
    """The reference env (backend fused -> its jnp tier) and the port's
    (fused -> the plain twin), res 6, a 20-dt warmup."""
    grid_j = jgrid.GridConfig(res=6, dt=0.01, poisson_iters=16)
    grid_t = tgrid.GridConfig(res=6, dt=0.01, poisson_iters=16)
    ej = jenv.CylinderEnv(jenv.EnvConfig(grid=grid_j, **ENV_KW),
                          backend="fused")
    et = tenv.CylinderEnv(tenv.EnvConfig(grid=grid_t, **ENV_KW),
                          backend="fused", device="cpu")
    return ej, et


# Env-level tolerances: after the 20-dt warmup and up to 2 intervals the
# port's fields differ from the reference's at the ~1e-5 level (see
# test_torch_solver); probes read p (O(1-10)) and rewards are O(1).
ATOL_OBS, ATOL_R = 2e-4, 2e-4


def test_reset_matches_reference(env_pair):
    ej, et = env_pair
    st_j, obs_j = ej.reset()
    st_t, obs_t = et.reset()
    assert et.cfg.cd0 == pytest.approx(ej.cfg.cd0, abs=1e-4)
    assert_close(obs_j, obs_t, ATOL_OBS, "obs")
    for r, o, tol in zip(st_j.flow, st_t.flow, (1e-5, 1e-5, 1e-4)):
        assert_close(r, o, tol, "flow")
    aux_j, aux_t = ej.obs_aux(st_j), et.obs_aux(st_t)
    assert_close(aux_j["xy"], aux_t["xy"], 1e-6, "aux xy")
    assert np.array_equal(np.asarray(aux_j["mask"]), to_np(aux_t["mask"]))


def test_env_step_two_intervals_match_reference(env_pair):
    ej, et = env_pair
    st_j, _ = ej.reset()
    st_t, _ = et.reset()
    for action in (0.7, -0.4):
        st_j, out_j = ej.env_step(st_j, jnp.float32(action))
        st_t, out_t = et.env_step(st_t, torch.tensor(action))
        assert_close(out_j.obs, out_t.obs, ATOL_OBS, "obs")
        for f in ("reward", "cd", "cl"):
            assert_close(getattr(out_j, f), getattr(out_t, f), ATOL_R, f)
        assert float(out_t.valid) == float(out_j.valid) == 1.0
        assert_close(st_j.jet_vel, st_t.jet_vel, 1e-6, "jet_vel")
    assert int(st_t.t) == 2


def test_env_step_batched_matches_single(env_pair):
    _, et = env_pair
    st, obs = et.reset()
    st_b, obs_b = tenv.broadcast_env_state(st, obs, 3)
    actions = torch.tensor([0.5, -1.5, 0.0])
    st_b2, out_b = et.env_step(st_b, actions)
    for i in range(3):
        _, out = et.env_step(st, actions[i])
        assert_close(out.reward, out_b.reward[i], 1e-5, f"reward env {i}")
        assert_close(out.obs, out_b.obs[i], 1e-5, f"obs env {i}")
    assert out_b.valid.tolist() == [1.0, 1.0, 1.0]


def test_sentinel_quarantines_a_diverged_env(env_pair):
    """A NaN in one env's flow resets that env to the warmup flow, zeroes
    its reward and marks it invalid; the other env is untouched."""
    _, et = env_pair
    st, obs = et.reset()
    st_b, _ = tenv.broadcast_env_state(st, obs, 2)
    bad_u = st_b.flow.u.clone()
    bad_u[1, 3, 3] = float("nan")
    st_bad = st_b._replace(flow=st_b.flow._replace(u=bad_u))
    st2, out = et.env_step(st_bad, torch.tensor([0.3, 0.3]))
    assert out.valid.tolist() == [1.0, 0.0]
    assert float(out.reward[1]) == 0.0 and float(st2.jet_vel[1]) == 0.0
    assert torch.equal(st2.flow.u[1], st_b.reset_flow.u[1])
    assert torch.isfinite(out.reward).all()


def test_guard_off_gives_the_same_step_without_valid(env_pair):
    """EnvConfig(guard=False): no sentinel, no valid mask, same physics."""
    _, et = env_pair
    plain = tenv.CylinderEnv(tenv.EnvConfig(grid=et.cfg.grid, guard=False,
                                            cd0=et.cfg.cd0, **ENV_KW),
                             backend="fused", device="cpu")
    plain._reset_flow = et._reset_flow
    st_g, _ = et.reset()
    st_p, _ = plain.reset()
    assert st_p.reset_flow is None
    _, out_g = et.env_step(st_g, torch.tensor(0.2))
    _, out_p = plain.env_step(st_p, torch.tensor(0.2))
    assert out_p.valid is None
    assert torch.equal(out_g.reward, out_p.reward)
    assert torch.equal(out_g.obs, out_p.obs)


def test_reset_batch_groups_and_cd0(env_pair):
    _, et = env_pair
    st_b, obs_b = et.reset_batch(["cyl_re100", "cyl_re100_sparse8"], 3)
    assert obs_b.shape == (3, 149)
    assert st_b.scn.probe_mask.sum(dim=-1).tolist() == [149.0, 8.0, 149.0]
    assert float(st_b.scn.cd0[0]) == pytest.approx(et.cfg.cd0, abs=1e-6)
