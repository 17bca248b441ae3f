"""Actor-critic networks.  The paper's policy: 2x512 tanh MLP (Rabault et
al.), Gaussian head with state-independent log-std; separate value MLP.

Port of ``repro.drl.networks``: the MLP (:class:`ActorCritic`) and the
permutation-invariant attention policy (:class:`AttentionActorCritic`,
``policy="attention"``) as ``nn.Module``s, plus the reference's functional
entry points, which take the module where ``repro`` took a parameter tree
and dispatch on its kind.  The attention policy turns each probe into a
token ``[x, y, p]``, mixes the set with a small pre-LN transformer encoder
(the dense, bidirectional ``gqa_attend``) and mean-pools the live tokens
into the actor and critic heads; padded probe slots are zeroed at the token
level and masked out of the attention keys and of the pool, so the output
is exactly invariant to garbage in masked slots.

``aux`` (``{"xy", "mask"}``, see ``CylinderEnv.obs_aux``) carries the probe
coordinates and the live-slot mask.  The MLP multiplies the observation by
the mask whenever aux is present and feeds the raw observation for
``aux=None``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import gqa_attend

POLICIES = ("mlp", "attention")


class PolicyConfig(NamedTuple):
    obs_dim: int = 149
    act_dim: int = 1
    hidden: int = 512
    depth: int = 2
    init_log_std: float = -0.5
    # -- attention-policy options (ignored by the MLP) ----------------------
    policy: str = "mlp"           # "mlp" | "attention"
    d_model: int = 64
    heads: int = 4
    kv_heads: int = 2
    layers: int = 2


def _dense_init_(w: torch.Tensor, fan_in: int,
                 generator: Optional[torch.Generator]) -> None:
    """Truncated-normal fan-in init in place (the reference's dense_init)."""
    std = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


def _linear(a: int, b: int, generator: Optional[torch.Generator], *,
            bias: bool = True) -> nn.Linear:
    lin = nn.Linear(a, b, bias=bias)
    _dense_init_(lin.weight, a, generator)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def _mlp(sizes, generator: Optional[torch.Generator]) -> nn.ModuleList:
    return nn.ModuleList(_linear(a, b, generator)
                         for a, b in zip(sizes[:-1], sizes[1:]))


def _mlp_apply(layers: nn.ModuleList, x, final_linear: bool = True):
    for i, lyr in enumerate(layers):
        x = lyr(x)
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


class ActorCritic(nn.Module):
    """Separate actor and critic MLPs and a state-independent log-std.

    ``nn.Linear`` stores ``(out, in)`` weights; the reference's ``(in,
    out)`` ``w`` converts with a transpose (``repro_torch.convert``).
    Built on the CPU (where ``generator`` draws); move it with ``.to``."""

    def __init__(self, cfg: PolicyConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.policy != "mlp":
            raise ValueError(f"ActorCritic is the MLP policy, got policy="
                             f"{cfg.policy!r}; init_actor_critic picks the "
                             f"module of {POLICIES}")
        self.cfg = cfg
        sizes = [cfg.obs_dim] + [cfg.hidden] * cfg.depth
        self.actor = _mlp(sizes + [cfg.act_dim], generator)
        self.critic = _mlp(sizes + [1], generator)
        self.log_std = nn.Parameter(torch.full(
            (cfg.act_dim,), cfg.init_log_std, dtype=torch.float32))


# ---------------------------------------------------------------------------
# permutation-invariant attention encoder (policy="attention")
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """The reference's ``_layernorm``: gain ``g`` and bias ``b``, biased
    variance, ``(x - mu) * rsqrt(var + eps) * g + b``."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(d, dtype=torch.float32))
        self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32))

    def forward(self, x):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.g + self.b


class EncoderBlock(nn.Module):
    """One pre-LN block: GQA self-attention, then a tanh MLP of width 4d.
    ``wq`` (d, heads, dh) and ``wk`` / ``wv`` (d, kv_heads, dh) keep the
    reference's factored layout; ``wo`` and the MLP are ``nn.Linear``."""

    def __init__(self, cfg: PolicyConfig,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_model // cfg.heads
        self.ln1 = LayerNorm(d)
        for name, h in (("wq", cfg.heads), ("wk", cfg.kv_heads),
                        ("wv", cfg.kv_heads)):
            w = nn.Parameter(torch.empty(d, h, dh, dtype=torch.float32))
            _dense_init_(w, d, generator)
            setattr(self, name, w)
        self.wo = _linear(cfg.heads * dh, d, generator, bias=False)
        self.ln2 = LayerNorm(d)
        self.mlp = _mlp([d, 4 * d, d], generator)

    def forward(self, h, kmask):
        B, P = h.shape[:2]
        x = self.ln1(h)
        q = torch.einsum("bpd,dhk->bphk", x, self.wq)
        k = torch.einsum("bpd,dhk->bphk", x, self.wk)
        v = torch.einsum("bpd,dhk->bphk", x, self.wv)
        h = h + self.wo(gqa_attend(q, k, v, kmask).reshape(B, P, -1))
        return h + _mlp_apply(self.mlp, self.ln2(h))


class AttentionActorCritic(nn.Module):
    """Set encoder over ``(x, y, p)`` probe tokens, masked mean pool, and
    actor / critic MLPs of width d_model over the pooled features; a
    state-independent log-std.  Built on the CPU (where ``generator``
    draws); move it with ``.to``."""

    def __init__(self, cfg: PolicyConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.policy != "attention":
            raise ValueError(f"AttentionActorCritic needs policy="
                             f"'attention', got {cfg.policy!r}")
        if (cfg.d_model // cfg.heads * cfg.heads != cfg.d_model
                or cfg.heads % cfg.kv_heads):
            raise ValueError(f"d_model={cfg.d_model} must split into heads="
                             f"{cfg.heads}, and heads must be a multiple of "
                             f"kv_heads={cfg.kv_heads}")
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _linear(3, d, generator)
        self.blocks = nn.ModuleList(EncoderBlock(cfg, generator)
                                    for _ in range(cfg.layers))
        self.ln_f = LayerNorm(d)
        self.actor = _mlp([d, d, cfg.act_dim], generator)
        self.critic = _mlp([d, d, 1], generator)
        self.log_std = nn.Parameter(torch.full(
            (cfg.act_dim,), cfg.init_log_std, dtype=torch.float32))

    def encode(self, obs, aux):
        """(..., P) probe values -> (..., d_model) pooled features, in the
        reference's order: tokens zeroed in padded slots before the
        embedding, padded keys masked out of every attend (the key-padding
        mask broadcast to (B, P, P)), the final LN, then the mean over live
        tokens divided by ``max(count, 1)``."""
        lead, P = obs.shape[:-1], obs.shape[-1]
        obs = obs.to(torch.float32)
        if aux is not None:
            mask = aux["mask"].to(obs.dtype).expand(obs.shape)
            xy = aux["xy"].to(obs.dtype).expand(*obs.shape, 2)
        else:
            mask = torch.ones_like(obs)
            xy = torch.zeros(*obs.shape, 2, dtype=obs.dtype,
                             device=obs.device)
        tokens = torch.cat([xy, obs[..., None]], dim=-1)
        tokens = tokens * mask[..., None]             # garbage-proof padding
        B = math.prod(lead)
        h = self.embed(tokens.reshape(B, P, 3))
        kmask = mask.reshape(B, 1, P) > 0             # key-padding mask
        for blk in self.blocks:
            h = blk(h, kmask)
        h = self.ln_f(h)
        m = mask.reshape(B, P, 1)
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
        return pooled.reshape(*lead, h.shape[-1])


def is_attention(model: nn.Module) -> bool:
    """Module dispatch: the attention policy carries the token embedding."""
    return isinstance(model, AttentionActorCritic)


def init_actor_critic(cfg: PolicyConfig, generator: torch.Generator,
                      device="cuda") -> nn.Module:
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r}; "
                         f"choose from {POLICIES}")
    cls = AttentionActorCritic if cfg.policy == "attention" else ActorCritic
    return cls(cfg, generator=generator).to(resolve_device(device))


def _features(model: nn.Module, obs, aux):
    """Policy input features: the raw (masked) probes for the MLP, the
    pooled set encoding for the attention policy."""
    if is_attention(model):
        return model.encode(obs, aux)
    if aux is not None:
        obs = obs * aux["mask"].to(obs.dtype)
    return obs


def policy_dist(model: nn.Module, obs, aux=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (mean (..., act_dim), log_std (act_dim,)); mean squashed to [-1,1]."""
    mean = torch.tanh(_mlp_apply(model.actor, _features(model, obs, aux)))
    return mean, model.log_std


def value(model: nn.Module, obs, aux=None) -> torch.Tensor:
    return _mlp_apply(model.critic, _features(model, obs, aux))[..., 0]


def _gauss_logp(act, mean, log_std):
    var = torch.exp(2 * log_std)
    lp = -0.5 * ((act - mean) ** 2 / var + 2 * log_std
                 + math.log(2 * math.pi))
    return torch.sum(lp, dim=-1)


def sample_action(model: nn.Module, obs, *,
                  generator: Optional[torch.Generator] = None, eps=None,
                  aux=None):
    """-> (action, log_prob).  ``eps`` (shaped like the mean) injects the
    standard-normal noise; otherwise it is drawn from ``generator``."""
    mean, log_std = policy_dist(model, obs, aux)
    std = torch.exp(log_std)
    if eps is None:
        # drawn on the generator's (CPU) device, then moved
        eps = action_noise(mean.shape, generator).to(mean.device)
    act = mean + std * eps
    return act, _gauss_logp(act, mean, log_std)


def action_noise(shape, generator: Optional[torch.Generator]):
    """The policy's standard-normal draw for a mean of ``shape``, on the
    generator's (CPU) device."""
    return torch.randn(shape, generator=generator)


def burn_action_noise(n: int, act_dim: int, steps: int,
                      generator: Optional[torch.Generator]) -> None:
    """Advance ``generator`` exactly as ``steps`` calls of
    ``sample_action`` on an (n, act_dim) mean without ``eps`` do: the same
    draws, in the same order, dropped.  Offline replay burns an episode's
    rollout noise this way, so the generator reaches the PPO update in the
    live run's state (one draw of steps * n * act_dim values need not
    leave it there)."""
    for _ in range(steps):
        action_noise((n, act_dim), generator)


def log_prob(model: nn.Module, obs, act, aux=None):
    mean, log_std = policy_dist(model, obs, aux)
    return _gauss_logp(act, mean, log_std)


def entropy(model: nn.Module) -> torch.Tensor:
    return torch.sum(0.5 * (1 + math.log(2 * math.pi)) + model.log_std)
