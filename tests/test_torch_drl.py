"""Parity of the port's DRL layer (repro_torch.drl/optim/convert) with the
reference (repro, JAX): MLP heads, GAE, AdamW and one PPO update."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.drl import gae as jgae
from repro.drl import networks as jnet
from repro.drl import ppo as jppo
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.drl import gae as tgae
from repro_torch.drl import networks as tnet
from repro_torch.drl import ppo as tppo
from repro_torch.optim import optimizers as topt
from tests._torch_parity import assert_close, max_diff, to_np

PCFG = dict(obs_dim=24, act_dim=1, hidden=64, depth=2)


def _jax_params(seed=0):
    return jnet.init_actor_critic(jnet.PolicyConfig(**PCFG),
                                  jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _obs(n, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, PCFG["obs_dim"])).astype(np.float32)


def _aux(n, seed=2):
    mask = (np.random.default_rng(seed).uniform(size=(n, PCFG["obs_dim"]))
            > 0.2).astype(np.float32)
    return mask


# A 3-layer float32 MLP: the two sides accumulate the dot products in
# different orders (XLA's vs PyTorch's CPU GEMM) -> ~1e-6 on O(1) outputs
ATOL_NET = 5e-6


@pytest.mark.parametrize("with_aux", [False, True])
def test_mlp_heads_match_with_converted_params(with_aux):
    params = _jax_params()
    model = params_from_jax(_np_tree(params), device="cpu")
    obs = _obs(16)
    mask = _aux(16)
    aux_j = {"xy": jnp.zeros((16, PCFG["obs_dim"], 2)),
             "mask": jnp.asarray(mask)} if with_aux else None
    aux_t = {"xy": torch.zeros(16, PCFG["obs_dim"], 2),
             "mask": torch.tensor(mask)} if with_aux else None
    mean_j, ls_j = jnet.policy_dist(params, jnp.asarray(obs), aux_j)
    mean_t, ls_t = tnet.policy_dist(model, torch.tensor(obs), aux_t)
    assert_close(mean_j, mean_t, ATOL_NET, "mean")
    assert_close(ls_j, ls_t, 0.0, "log_std")
    assert_close(jnet.value(params, jnp.asarray(obs), aux_j),
                 tnet.value(model, torch.tensor(obs), aux_t), ATOL_NET,
                 "value")
    act = np.random.default_rng(3).standard_normal((16, 1)).astype(
        np.float32)
    assert_close(jnet.log_prob(params, jnp.asarray(obs), jnp.asarray(act),
                               aux_j),
                 tnet.log_prob(model, torch.tensor(obs), torch.tensor(act),
                               aux_t), 2e-5, "log_prob")
    assert_close(jnet.entropy(params), tnet.entropy(model), 1e-6, "entropy")


def test_sample_action_with_injected_noise():
    """The reference's normal draw, injected as eps, gives its action."""
    params = _jax_params()
    model = params_from_jax(_np_tree(params), device="cpu")
    obs = _obs(1)[0]
    key = jax.random.PRNGKey(7)
    act_j, logp_j = jnet.sample_action(params, jnp.asarray(obs), key)
    eps = np.asarray(jax.random.normal(key, (1,)))
    act_t, logp_t = tnet.sample_action(model, torch.tensor(obs),
                                       eps=torch.tensor(eps))
    assert_close(act_j, act_t, ATOL_NET, "action")
    assert_close(logp_j, logp_t, 2e-5, "logp")


def test_params_roundtrip_and_shapes():
    tree = _np_tree(_jax_params())
    model = params_from_jax(tree, device="cpu")
    back = params_to_numpy(model)
    for side in ("actor", "critic"):
        for a, b in zip(tree[side], back[side]):
            assert np.array_equal(a["w"], b["w"])
            assert np.array_equal(a["b"], b["b"])
    assert model.actor[0].weight.shape == (PCFG["hidden"], PCFG["obs_dim"])
    fresh = tnet.init_actor_critic(tnet.PolicyConfig(**PCFG),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    w = fresh.actor[0].weight.detach()
    # truncated at 2 std of the fan-in scale, zero biases
    assert float(w.abs().max()) <= 2.0 / np.sqrt(PCFG["obs_dim"]) + 1e-6
    assert float(fresh.actor[0].bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("with_valid", [False, True])
def test_gae_matches(with_valid):
    rng = np.random.default_rng(4)
    r = rng.standard_normal((3, 12)).astype(np.float32)
    v = rng.standard_normal((3, 12)).astype(np.float32)
    lv = rng.standard_normal(3).astype(np.float32)
    valid = None
    if with_valid:
        valid = np.ones((3, 12), np.float32)
        valid[0, 5] = valid[2, 0] = valid[2, 11] = 0.0
    kw = dict(gamma=0.99, lam=0.95)
    ref = jgae.gae_batch(jnp.asarray(r), jnp.asarray(v), jnp.asarray(lv),
                         valid=None if valid is None else jnp.asarray(valid),
                         **kw)
    out = tgae.gae_batch(torch.tensor(r), torch.tensor(v), torch.tensor(lv),
                         valid=None if valid is None else torch.tensor(valid),
                         **kw)
    for a, b in zip(ref, out):
        assert_close(a, b, 1e-5, "gae")          # 12-step recursion, O(1)
    if with_valid:
        assert float(out[0][0, 5]) == 0.0


def test_adamw_matches():
    """Five clipped AdamW steps on fixed gradients: same bias-corrected
    arithmetic, so the params agree to float32 rounding."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (3,), (2, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    oj = jopt.adamw(1e-2, max_grad_norm=0.5)
    ot = topt.adamw(1e-2, max_grad_norm=0.5)
    pj, sj = [jnp.asarray(p) for p in p0], None
    pt = [torch.tensor(p) for p in p0]
    sj, st = oj.init(pj), ot.init(pt)
    for step, g in enumerate(grads):
        pj, sj = oj.update([jnp.asarray(x) for x in g], sj, pj, step)
        pt, st = ot.update([torch.tensor(x) for x in g], st, pt, step)
    for a, b in zip(pj, pt):
        assert_close(a, b, 1e-6, "params")
    gn_j = jopt.global_norm([jnp.asarray(x) for x in grads[0]])
    gn_t = topt.global_norm([torch.tensor(x) for x in grads[0]])
    assert_close(gn_j, gn_t, 1e-6, "global_norm")


def _batch(n, seed=6, valid=None):
    rng = np.random.default_rng(seed)
    return dict(obs=_obs(n, seed), act=rng.standard_normal((n, 1)).astype(
        np.float32), logp_old=rng.uniform(-2, 0, n).astype(np.float32),
        adv=rng.standard_normal(n).astype(np.float32),
        ret=rng.standard_normal(n).astype(np.float32), valid=valid)


@pytest.mark.parametrize("with_valid", [False, True])
def test_ppo_loss_matches(with_valid):
    params = _jax_params()
    model = params_from_jax(_np_tree(params), device="cpu")
    valid = None
    if with_valid:
        valid = np.ones(32, np.float32)
        valid[3] = 0.0
    b = _batch(32, valid=valid)
    bj = jppo.Batch(**{k: None if x is None else jnp.asarray(x)
                       for k, x in b.items()})
    bt = tppo.Batch(**{k: None if x is None else torch.tensor(x)
                       for k, x in b.items()})
    cfg = jppo.PPOConfig()
    lj, mj = jppo.ppo_loss(cfg, params, bj)
    lt, mt = tppo.ppo_loss(tppo.PPOConfig(), model, bt)
    assert_close(lj, lt, 2e-5, "loss")
    for k in mj:
        assert_close(mj[k], mt[k], 2e-5, k)


def test_one_ppo_update_with_reference_permutations():
    """One full update (10 epochs x 4 minibatches) from the same params, the
    epoch permutations drawn by the reference (split(key, epochs) ->
    permutation) and injected.  40 clipped Adam steps of lr 3e-4: the
    params move by ~1e-2; float32 gradient differences (~1e-6 relative)
    keep the two runs within 1e-4 of each other."""
    params = _jax_params()
    model = params_from_jax(_np_tree(params), device="cpu")
    b = _batch(64, seed=8)
    cfg_j, cfg_t = jppo.PPOConfig(), tppo.PPOConfig()
    opt_j = jppo.make_optimizer(cfg_j)
    opt_t = tppo.make_optimizer(cfg_t)
    key = jax.random.PRNGKey(11)
    pj, sj, step_j, mj = jppo.ppo_update(
        cfg_j, opt_j, params, opt_j.init(params),
        jppo.Batch(**{k: None if x is None else jnp.asarray(x)
                      for k, x in b.items()}), key, jnp.int32(0))
    perms = np.stack([np.asarray(jax.random.permutation(k, 64))
                      for k in jax.random.split(key, cfg_j.epochs)])
    st, step_t, mt = tppo.ppo_update(
        cfg_t, opt_t, model, opt_t.init(list(model.parameters())),
        tppo.Batch(**{k: None if x is None else torch.tensor(x)
                      for k, x in b.items()}), 0, perms=perms)
    assert int(step_j) == step_t == 40
    out = params_to_numpy(model)
    moved = 0.0
    for side in ("actor", "critic"):
        for a, o, p0 in zip(pj[side], out[side], params[side]):
            assert max_diff(a["w"], o["w"])[0] <= 1e-4
            assert max_diff(a["b"], o["b"])[0] <= 1e-4
            moved = max(moved, max_diff(p0["w"], o["w"])[0])
    assert moved > 1e-3                      # the update did move the params
    assert max_diff(pj["log_std"], out["log_std"])[0] <= 1e-4
    for k in ("policy_loss", "value_loss", "approx_kl"):
        assert_close(mj[k], mt[k], 1e-4, k)
    assert float(mt["grad_skips"]) == 0.0


def test_ppo_update_guard_off_equals_guard_on_when_finite():
    """skip_nonfinite_grads only selects: on finite gradients both settings
    give the same params."""
    b = _batch(32, seed=10)
    perms = np.stack([np.random.default_rng(e).permutation(32)
                      for e in range(2)])
    out = []
    for skip in (True, False):
        model = params_from_jax(_np_tree(_jax_params()),
                                device="cpu")
        cfg = tppo.PPOConfig(epochs=2, skip_nonfinite_grads=skip)
        opt = tppo.make_optimizer(cfg)
        _, step, m = tppo.ppo_update(
            cfg, opt, model, opt.init(list(model.parameters())),
            tppo.Batch(**{k: None if x is None else torch.tensor(x)
                          for k, x in b.items()}), 0, perms=perms)
        assert step == 8 and ("grad_skips" in m) == skip
        out.append([p.detach().clone() for p in model.parameters()])
    for a, c in zip(*out):
        assert torch.equal(a, c)


def test_ppo_update_skips_nonfinite_gradients():
    model = params_from_jax(_np_tree(_jax_params()),
                                device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    b = _batch(32, seed=9)
    b["adv"][0] = np.nan
    cfg = tppo.PPOConfig(epochs=1, minibatches=1, normalize_adv=False)
    opt = tppo.make_optimizer(cfg)
    st, step, m = tppo.ppo_update(
        cfg, opt, model, opt.init(list(model.parameters())),
        tppo.Batch(**{k: None if x is None else torch.tensor(x)
                      for k, x in b.items()}), 0,
        perms=np.arange(32)[None])
    assert step == 1 and float(m["grad_skips"]) == 1.0
    for a, p in zip(before, model.parameters()):
        assert torch.equal(a, p)
    assert all(float(x.abs().max()) == 0.0 for x in st["m"])
    assert to_np(m["grad_norm"]) == 0.0
