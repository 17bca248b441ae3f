"""The plain reference against the port's CPU path at a tiny grid, and
the reference's imports."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from afcbench.reference import cfd as R
from afcbench.reference import ppo as RP

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_reference_imports_nothing_of_the_program_or_jax():
    root = Path(R.__file__).resolve().parent
    found = set()
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                found |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                found.add(node.module.split(".")[0])
    assert found and not found & FORBIDDEN, found & FORBIDDEN


def _port_batch(scenario, n_envs=2, res=4):
    from repro_torch.cfd.env import CylinderEnv, EnvConfig
    from repro_torch.cfd.grid import GridConfig
    cfg = EnvConfig(grid=GridConfig(res=res), steps_per_action=3,
                    warmup_time=0.05)
    env = CylinderEnv(cfg, backend="fused", device="cpu")
    st, obs = env.reset_batch((scenario,), n_envs)
    return env, st, obs


@pytest.mark.parametrize("scenario", ["cyl_re100", "pinball_re100"])
def test_env_step_matches_the_port(scenario):
    env, st, _ = _port_batch(scenario)
    rng = np.random.default_rng(0)
    shape = st.jet_vel.shape
    action = torch.tensor(rng.uniform(-1.2, 1.2, shape), dtype=torch.float32)
    st2, out = env.env_step(st, action)
    grid = R.Grid(res=4)
    b = R.make_batch(grid, [scenario] * shape[0], "cpu")
    s = R.env_step(grid, b, R.Flow(st.flow.u, st.flow.v, st.flow.p),
                   st.jet_vel, action, st.scn.cd0, steps_per_action=3,
                   beta=0.4, omega_l=0.1)
    for got, want in ((st2.flow.u, s.flow.u), (st2.flow.v, s.flow.v),
                      (st2.flow.p, s.flow.p), (out.obs, s.obs),
                      (out.reward, s.reward), (out.cd, s.cd),
                      (out.cl, s.cl), (st2.jet_vel, s.amp)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("scenario", ["cyl_re100", "pinball_re100",
                                      "tandem_re100", "cyl_re200_sparse24"])
def test_geometry_and_probes_match_the_port(scenario):
    from repro_torch.cfd import grid as G
    from repro_torch.cfd import scenarios as S
    grid = R.Grid(res=6)
    scn = S.get_scenario(scenario)
    port = G.build_geometry(G.GridConfig(res=6), scn.geometry)
    ref = R.geometry(grid, scn.geometry)
    nb = port.n_bodies
    for k in ("chi_u", "chi_v", "jet_u", "jet_v", "jmask_u", "jmask_v",
              "rot_u", "rot_v", "rmask_u", "rmask_v", "inlet_u"):
        np.testing.assert_allclose(ref[k], getattr(port, k), atol=1e-12)
    for k in ("rotb_u", "rotb_v", "own_u", "own_v"):
        np.testing.assert_allclose(ref[k][:nb], getattr(port, k), atol=1e-12)
        assert not ref[k][nb:].any()
    params = S.scenario_params(scn, G.GridConfig(res=6), cd0=1.0,
                               device="cpu")
    np.testing.assert_array_equal(R.probe_ij(grid, scn.probes),
                                  params.probe_ij.numpy())


def _policy(obs_dim=7, act_dim=2, seed=3):
    from repro_torch.drl import networks
    from afcbench import program
    cfg = networks.PolicyConfig(obs_dim=obs_dim, act_dim=act_dim, hidden=16)
    model = networks.init_actor_critic(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    w = program.weights(obs_dim, act_dim, 16, 2, -0.5, seed, "cpu")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(w[k])
    return model, w


def test_policy_and_value_match_the_port():
    from repro_torch.drl import networks
    model, w = _policy()
    obs = torch.randn(5, 6, 7)
    mask = torch.ones(5, 1, 7)
    eps = torch.randn(5, 6, 2)
    act, logp = networks.sample_action(model, obs, eps=eps,
                                       aux={"mask": mask, "xy": None})
    mean = RP.mean_action(w, obs, mask)
    torch.testing.assert_close(RP.log_prob(act, mean, w["log_std"]), logp)
    torch.testing.assert_close(RP.value(w, obs, mask),
                               networks.value(model, obs, {"mask": mask}))


def test_loss_gradient_and_adam_step_match_the_port():
    from repro_torch.drl import ppo as P
    model, w = _policy()
    n = 12
    batch = P.Batch(obs=torch.randn(n, 7), act=torch.randn(n, 2),
                    logp_old=torch.randn(n) - 2, adv=torch.randn(n),
                    ret=torch.randn(n), probe_xy=torch.zeros(n, 7, 2),
                    probe_mask=torch.ones(n, 7))
    cfg = P.PPOConfig()
    loss, _ = P.ppo_loss(cfg, model, batch)
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    mb = {"obs": batch.obs, "act": batch.act, "logp_old": batch.logp_old,
          "adv": batch.adv, "ret": batch.ret, "mask": batch.probe_mask}
    rcfg = RP.PPO()
    torch.testing.assert_close(RP.loss(rcfg, w, mb), loss.detach())
    ref = RP.gradient(rcfg, w, mb)
    names = [k for k, _ in model.named_parameters()]
    for k, g in zip(names, grads):
        torch.testing.assert_close(ref[k], g, rtol=1e-5, atol=1e-7)
    opt = P.make_optimizer(cfg)
    new_p, _ = opt.update(list(grads), opt.init(params), params, 0)
    p1, _ = RP.adam_step(rcfg, w, RP.adam_init(w), ref, 0)
    for k, q in zip(names, new_p):
        torch.testing.assert_close(p1[k], q, rtol=1e-5, atol=1e-7)


def test_the_control_rounds_products_to_tf32():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, 3.0])
    assert RP.tf32_round(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]
