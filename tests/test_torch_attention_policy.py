"""The port's attention policy against ``repro.drl.networks``.

Weights are the reference's own init, carried by
``convert.params_from_jax``; observations, probe coordinates and the live
mask come from a seeded numpy generator with a batched leading dim and
padded slots.  The pooled features, ``policy_dist``, ``value`` and
``log_prob`` are held within ATOL of the reference: both run float32 on
the CPU, and only the order of the sums differs.  The set-function
properties mirror tests/test_attention_policy.py: masked-slot garbage
changes nothing, bit for bit (tokens zeroed, keys masked, the pool
masked), and a permutation of the live probes changes the outputs only by
the order of the sums."""
import jax
import numpy as np
import pytest
import torch

from repro.drl import networks as jnet
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.drl import networks as tnet
from tests._torch_parity import max_diff

ATOL = 1e-5
P, LIVE, ACT = 149, 59, 3       # the pinball's 59 probes padded to 149


def _jax_params(policy, **kw):
    cfg = jnet.PolicyConfig(obs_dim=P, act_dim=ACT, policy=policy, **kw)
    return jax.tree.map(np.asarray,
                        jnet.init_actor_critic(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def attn():
    """The reference's attention params at PolicyConfig's own widths (d 64,
    4 heads over 2 KV heads, 2 layers) and the port's module on them."""
    params = _jax_params("attention")
    return params, params_from_jax(params, "cpu")


def _inputs(lead, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal(lead + (P,)).astype(np.float32)
    xy = rng.uniform(-1, 1, (P, 2)).astype(np.float32)
    mask = np.concatenate([np.ones(LIVE), np.zeros(P - LIVE)]
                          ).astype(np.float32)
    aux = {"xy": np.broadcast_to(xy, lead + (P, 2)).copy(),
           "mask": np.broadcast_to(mask, lead + (P,)).copy()}
    return obs * aux["mask"], aux


def _t(aux):
    return None if aux is None else {k: torch.tensor(v)
                                     for k, v in aux.items()}


@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_attention_policy_matches_reference(attn, lead):
    """(P,), (N, P) and (N, T, P) observations (the rollout's and the
    postprocess's shapes) with the pinball's padded mask."""
    params, model = attn
    obs, aux = _inputs(lead)
    act = np.random.default_rng(1).standard_normal(lead + (ACT,)).astype(
        np.float32)
    obs_t, aux_t = torch.tensor(obs), _t(aux)
    with torch.no_grad():
        feats = model.encode(obs_t, aux_t)
        mu, log_std = tnet.policy_dist(model, obs_t, aux_t)
        v = tnet.value(model, obs_t, aux_t)
        lp = tnet.log_prob(model, obs_t, torch.tensor(act), aux_t)
    ref_feats = jnet._encode(params, obs, aux)
    ref_mu, ref_log_std = jnet.policy_dist(params, obs, aux)
    assert feats.shape == lead + (64,)
    assert mu.shape == lead + (ACT,) and v.shape == lead
    for what, ref, out in (("features", ref_feats, feats), ("mean", ref_mu, mu),
                           ("log_std", ref_log_std, log_std),
                           ("value", jnet.value(params, obs, aux), v),
                           ("log_prob", jnet.log_prob(params, obs, act, aux),
                            lp)):
        assert max_diff(ref, out)[0] <= ATOL, what


def test_attention_policy_without_aux_matches_reference(attn):
    """aux=None: every slot live, coordinates zero."""
    params, model = attn
    obs, _ = _inputs((4,))
    with torch.no_grad():
        mu, _ = tnet.policy_dist(model, torch.tensor(obs))
        v = tnet.value(model, torch.tensor(obs))
    assert max_diff(jnet.policy_dist(params, obs)[0], mu)[0] <= ATOL
    assert max_diff(jnet.value(params, obs), v)[0] <= ATOL


@pytest.mark.parametrize("policy", tnet.POLICIES)
def test_masked_slots_cannot_leak(policy):
    """Garbage in the padded slots changes neither the distribution, the
    value nor a sampled action, bit for bit, for both architectures."""
    model = tnet.init_actor_critic(
        tnet.PolicyConfig(obs_dim=P, act_dim=ACT, policy=policy),
        torch.Generator().manual_seed(0), device="cpu")
    obs, aux = _inputs((4,), seed=2)
    garbage = obs + (1.0 - aux["mask"]) * 1e3
    aux_t = _t(aux)
    eps = torch.randn(4, ACT, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        outs = [(tnet.policy_dist(model, torch.tensor(o), aux_t)[0],
                 tnet.value(model, torch.tensor(o), aux_t),
                 *tnet.sample_action(model, torch.tensor(o), eps=eps,
                                     aux=aux_t))
                for o in (obs, garbage)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_attention_is_permutation_invariant(attn):
    """Shuffling the live probe tokens (coordinates and values together)
    leaves the outputs within the order of the sums."""
    _, model = attn
    obs, aux = _inputs((4,), seed=4)
    perm = np.concatenate([np.random.default_rng(0).permutation(LIVE),
                           np.arange(LIVE, P)])
    aux_p = {"xy": aux["xy"][:, perm], "mask": aux["mask"][:, perm]}
    with torch.no_grad():
        mu0, _ = tnet.policy_dist(model, torch.tensor(obs), _t(aux))
        mu1, _ = tnet.policy_dist(model, torch.tensor(obs[:, perm]),
                                  _t(aux_p))
        v0 = tnet.value(model, torch.tensor(obs), _t(aux))
        v1 = tnet.value(model, torch.tensor(obs[:, perm]), _t(aux_p))
    assert max_diff(mu0, mu1)[0] <= ATOL
    assert max_diff(v0, v1)[0] <= ATOL


def test_attention_gradients_are_finite():
    """The PPO update differentiates the encoder at (N, T, P)."""
    model = tnet.init_actor_critic(
        tnet.PolicyConfig(obs_dim=P, act_dim=ACT, policy="attention"),
        torch.Generator().manual_seed(0), device="cpu")
    obs, aux = _inputs((2, 3), seed=5)
    loss = torch.sum(tnet.value(model, torch.tensor(obs), _t(aux)))
    grads = torch.autograd.grad(loss, [p for n, p in model.named_parameters()
                                       if not n.startswith("actor")
                                       and n != "log_std"])
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_policy_config_validation():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="policy"):
        tnet.init_actor_critic(tnet.PolicyConfig(obs_dim=8,
                                                 policy="transformer"),
                               gen, device="cpu")
    with pytest.raises(ValueError, match="d_model"):
        tnet.init_actor_critic(tnet.PolicyConfig(
            obs_dim=8, policy="attention", d_model=30, heads=4), gen,
            device="cpu")
    with pytest.raises(ValueError, match="kv_heads"):
        tnet.init_actor_critic(tnet.PolicyConfig(
            obs_dim=8, policy="attention", heads=4, kv_heads=3), gen,
            device="cpu")
    assert tnet.POLICIES == jnet.POLICIES
    assert tnet.PolicyConfig()._asdict() == jnet.PolicyConfig()._asdict()


@pytest.mark.parametrize("policy,kw", [
    ("attention", {}),
    ("attention", dict(d_model=32, heads=4, kv_heads=4, layers=1)),
    ("mlp", dict(hidden=32)),
])
def test_params_round_trip(policy, kw):
    """Reference tree -> port module -> tree again, leaf for leaf exact;
    the factored (d, heads, dh) q/k/v weights keep their shape."""
    params = _jax_params(policy, **kw)
    model = params_from_jax(params, "cpu")
    assert tnet.is_attention(model) == (policy == "attention")
    back = params_to_numpy(model)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in flat] == [k for k, _ in flat_back]
    for (path, a), (_, b) in zip(flat, flat_back):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    if policy == "attention":
        d = model.cfg.d_model
        assert model.blocks[0].wq.shape == (d, model.cfg.heads,
                                            d // model.cfg.heads)
