"""Mixture of experts: a top-k router and a capacity-bounded, sort-based
dispatch.

Port of ``repro.models.moe``.  The router is a float32 softmax gate, its
top-k probabilities renormalised over the selected experts, with the
Switch load-balance loss as the auxiliary loss.  ``_moe_dispatch`` sorts
the (token, slot) pairs by expert, keeps the first ``C`` of each expert
(the capacity), runs every expert over its ``C`` rows of an expert-major
(E, C, D) buffer as batched products, and adds each kept pair's output,
weighted by its probability, back to its token: a token's K terms in
ascending expert order, rounded to the compute dtype after each add, as
the reference's scatter-add adds them on the CPU (``combine``), and so in
one fixed order on the card too.

``cfg.moe.impl``:

* ``"gspmd"``: the dispatch, in token waves of at most
  :data:`MOE_TOKEN_WAVE` tokens along the sequence when the input is
  longer (each wave its own capacity; the aux is the mean of the waves').
* ``"shard_map"``: the explicit all-to-all expert parallelism
  (``models/moe_shard_map.py``, the ranks a dimension of the tensors on
  one controller) under a mesh with a "model" axis; with no mesh, or one
  it cannot use, the dispatch itself, with no waves, as the reference
  falls back.

Under a mesh the (E, C, D) buffer carries the reference's constraint
(experts on "model"; ``act_sharding.constrain`` records it).  The expert
products run outside any kernel in the reference (``jnp.einsum``), and so
in plain PyTorch here.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import act_sharding
from repro_torch.models.layers import dense_init, dtype_of

# the most tokens dispatched at once (the (E, C, D) buffer's memory bound)
MOE_TOKEN_WAVE = 65_536


def _stacked_init(gen, lead, shape, dtype):
    """``dense_init`` of a stack of ``lead`` layers of ``shape``, drawn one
    layer at a time, so that a layer's float32 draw is the largest buffer
    beside the result (a 16-layer stack of phi3.5's experts is 27 GB in
    float32)."""
    lead = tuple(lead)
    if not lead or gen.device.type == "meta":
        return dense_init(gen, lead + tuple(shape), dtype)
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=gen.device)
    for w in out.view(-1, *shape):
        w.copy_(dense_init(gen, shape, dtype))
    return out


def init_moe(cfg: ModelConfig, gen: torch.Generator, lead=()):
    """The router (float32 whatever ``param_dtype`` is), the experts'
    ``we1`` / ``we3`` (E, D, F) and ``we2`` (E, F, D), and the shared
    experts (F times ``num_shared_experts`` wide) where the config has
    them; ``lead``: leading stack axes, ``(L,)`` for a stack of layers."""
    m = cfg.moe
    dt = dtype_of(cfg.param_dtype)
    lead = tuple(lead)
    E, D, Fe = m.num_experts, cfg.d_model, m.d_ff_expert
    p = {"w_router": dense_init(gen, lead + (D, E), torch.float32),
         "we1": _stacked_init(gen, lead, (E, D, Fe), dt),
         "we3": _stacked_init(gen, lead, (E, D, Fe), dt),
         "we2": _stacked_init(gen, lead, (E, Fe, D), dt)}
    if m.num_shared_experts:
        Fs = Fe * m.num_shared_experts
        p["shared"] = {"w1": dense_init(gen, lead + (D, Fs), dt),
                       "w3": dense_init(gen, lead + (D, Fs), dt),
                       "w2": dense_init(gen, lead + (Fs, D), dt)}
    return p


def router(cfg: ModelConfig, p, xf) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """xf (T, D) -> (top_p (T, K), top_idx (T, K), aux loss scalar).

    The top k by a stable descending sort of the probabilities, so that of
    two equal probabilities the lower expert comes first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    m = cfg.moe
    logits = xf.float() @ p["w_router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (T, E)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[:, :m.top_k], top_idx[:, :m.top_k]
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    # the Switch load-balance loss: E * sum_e f_e * P_e
    E = m.num_experts
    f_e = F.one_hot(top_idx, E).float().sum(1).mean(0)   # share routed
    p_e = probs.mean(0)
    aux = E * (f_e * p_e).sum() * m.router_aux_weight
    return top_p, top_idx, aux


def _capacity(cfg: ModelConfig, T: int) -> int:
    """Rows per expert for T tokens: K T cf / E, rounded up to a multiple
    of 8, at least 8."""
    m = cfg.moe
    c = int(m.top_k * T * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def apply_moe(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux loss)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    if m.impl == "shard_map":
        from repro_torch.models.moe_shard_map import \
            apply_moe_expert_parallel
        return apply_moe_expert_parallel(cfg, p, x)
    s_wave = max(1, MOE_TOKEN_WAVE // B)
    if T > MOE_TOKEN_WAVE and S % s_wave == 0 and S > s_wave:
        # waves along the sequence, each with its own capacity
        outs, auxs = zip(*(_moe_dispatch(cfg, p, x[:, w:w + s_wave])
                           for w in range(0, S, s_wave)))
        return torch.cat(outs, dim=1), torch.stack(auxs).mean()
    return _moe_dispatch(cfg, p, x)


def dispatch_plan(cfg: ModelConfig, top_idx, C: int):
    """The sort-based dispatch of the (token, slot) pairs ``top_idx`` (T,
    K) into ``C`` rows per expert -> (order: the pairs' token-major flat
    indices (t K + k) sorted by expert, stably; their expert; their row
    within it; keep: row < C).  A stable sort keeps the lower flat index
    first within an expert, as the reference's ``jnp.argsort`` does, so
    both keep the same pairs when an expert overflows."""
    E = cfg.moe.num_experts
    flat_expert = top_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    e_s = flat_expert[order]
    # each expert's first index in the sorted list: the exclusive cumsum
    # of the counts
    starts = torch.searchsorted(e_s, torch.arange(E, device=e_s.device,
                                                  dtype=e_s.dtype))
    pos = torch.arange(e_s.numel(), device=e_s.device) - starts[e_s]
    return order, e_s, pos, pos < C


def combine(out_buf, slot, w, order, top_idx):
    """The weighted expert outputs added back to their tokens, in the
    compute dtype: ``out_buf`` (rows, D) the experts' output rows; ``slot``
    and ``w`` (T K,) each pair's row and weight in ``dispatch_plan``'s
    sorted ``order``; ``top_idx`` (T, K) -> y (T, D).

    The reference's scatter-add (``.at[t_s].add``) meets a token's K terms
    in the sorted order, which is ascending expert, and rounds after each
    add (XLA on the CPU); so does this loop, K gathers, products and adds
    of (T, D).  ``index_add_`` would sum each token's terms in float32 and
    round once on the CPU (in bf16 it matches the reference at K = 2 and
    in about half the elements at K = 8), and on CUDA in no fixed order."""
    T, K = top_idx.shape
    slot_t, w_t = torch.empty_like(slot), torch.empty_like(w)
    slot_t[order], w_t[order] = slot, w            # token-major: t K + k
    by_expert = top_idx.argsort(dim=1)
    slot_t = slot_t.view(T, K).gather(1, by_expert)
    w_t = w_t.view(T, K).gather(1, by_expert)
    y = out_buf.new_zeros((T, out_buf.shape[1]))
    for k in range(K):
        y = y + out_buf[slot_t[:, k]] * w_t[:, k, None]
    return y


def _moe_dispatch(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    m = cfg.moe
    cd = dtype_of(cfg.compute_dtype)
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    top_p, top_idx, aux = router(cfg, p, xf)
    K, E = m.top_k, m.num_experts
    C = _capacity(cfg, T)
    order, e_s, pos, keep = dispatch_plan(cfg, top_idx, C)
    t_s = order // K
    p_s = top_p.reshape(-1)[order]
    xc = xf.to(cd)

    # the expert-major buffer, flat (E C rows and one spare): each kept
    # pair's row written to its own slot by assignment, every dropped pair
    # to the spare row, which is cut off (the reference adds a dropped
    # pair's zeroed row to slot 0 of its expert, which changes nothing)
    slot = torch.where(keep, e_s * C + pos, E * C)
    buf = xc.new_zeros((E * C + 1, D))
    buf[slot] = xc[t_s]
    buf = act_sharding.constrain(buf[:E * C].view(E, C, D), "model")

    h = F.silu(torch.bmm(buf, p["we1"].to(cd))) * torch.bmm(
        buf, p["we3"].to(cd))
    out_buf = torch.bmm(h, p["we2"].to(cd)).view(E * C, D)

    # a dropped pair reads slot 0 of its expert and adds it times 0, as the
    # reference does
    slot_c = torch.where(keep, slot, e_s * C)
    y = combine(out_buf, slot_c, (p_s * keep).to(cd), order, top_idx)

    if m.num_shared_experts and "shared" in p:
        sp = p["shared"]
        hs = F.silu(xc @ sp["w1"].to(cd)) * (xc @ sp["w3"].to(cd))
        y = y + hs @ sp["w2"].to(cd)
    return y.reshape(B, S, D), aux
