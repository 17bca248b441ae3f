"""Expert-parallel mixture of experts: the reference's two-hop all-to-all
dispatch, on one controller.

Port of ``repro.models.moe_shard_map``.  The reference runs this under
``shard_map`` on a mesh with a "model" axis of EP ranks:

  1. tokens are sharded over (dp x "model"), the (B, S) grid cut into
     ``(n_dp, B / n_dp, EP, S / EP)``; experts over "model", E / EP each;
  2. each shard routes its own tokens (its own load-balance aux, then
     averaged over the mesh) and packs its (token, slot) pairs into
     per-destination-rank buckets of ``c_send`` rows;
  3. an all-to-all along "model" delivers the buckets to the experts'
     owners;
  4. each owner packs what it received (every bucket row, the empty ones
     as zero rows of its expert 0) into ``c_exp`` rows per local expert
     and runs them as grouped products;
  5. the results return through the inverse all-to-all and each pair's
     output, weighted by its probability, is added to its token in the
     token-major ``(t, k)`` order of the reference's scatter-add (not the
     expert order of ``moe.combine``).

Here every shard lives on the one device: the shards are a leading
dimension ``G = n_dp x EP`` of the tensors (dp-major; a pod mesh's dp
index is ``pod x n_data + data``), and the all-to-all within each dp
group is a transpose of the (source rank, destination rank) dimensions.
The experts' weights are whole (the reference all-gathers their FSDP
shards), so the products run as one batched product per expert over the
rows of every dp group.  A dropped pair adds nothing; a bucket keeps each
group's rows in their order (a stable sort, as the reference's
``jnp.argsort``).  No kernel: the reference's expert products are
``jnp.einsum``, and so plain ``torch.bmm`` here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import cost_analysis
from repro_torch.models import act_sharding
from repro_torch.models.layers import dtype_of


def _plan(groups, n_groups: int, capacity: int):
    """The bucket plan of each shard's rows ``groups`` (G, N) (a row's
    group id) into ``capacity`` rows per group -> (order: the flat rows
    sorted stably by (shard, group); base: each sorted row's group's first
    flat slot; slot: its flat slot, or the spare slot past the end where
    it overflows; keep)."""
    G, N = groups.shape
    dev = groups.device
    gid = (groups.long() + n_groups * torch.arange(G, device=dev)[:, None]
           ).reshape(-1)
    order = torch.argsort(gid, stable=True)
    g_s = gid[order]
    starts = torch.searchsorted(g_s, torch.arange(G * n_groups, device=dev))
    pos = torch.arange(G * N, device=dev) - starts[g_s]
    keep = pos < capacity
    base = g_s * capacity
    slot = torch.where(keep, base + pos, G * n_groups * capacity)
    return order, base, slot, keep


def _pack(plan, payload, n_groups: int, capacity: int):
    """``payload`` (G, N, ...) packed by ``plan`` into buckets (G,
    n_groups, capacity, ...): each kept row in its slot, empty slots zero,
    overflowing rows dropped."""
    order, _, slot, _ = plan
    G, N = payload.shape[:2]
    rest = payload.shape[2:]
    n_slots = G * n_groups * capacity
    out = payload.new_zeros((n_slots + 1,) + rest)
    out[slot] = payload.reshape((G * N,) + rest)[order]
    return out[:n_slots].view((G, n_groups, capacity) + rest)


def _unpack(plan, buckets, N: int):
    """Each row's bucket slot read back into its place (G, N, ...): a
    dropped row reads its group's slot 0 times 0, as the reference's."""
    order, base, slot, keep = plan
    G = buckets.shape[0]
    rest = buckets.shape[3:]
    flat = buckets.reshape((-1,) + rest)
    vals = flat[torch.where(keep, slot, base)] * keep.view(
        (-1,) + (1,) * len(rest)).to(flat.dtype)
    out = torch.empty_like(vals)
    out[order] = vals
    return out.view((G, N) + rest)


def layout(cfg: ModelConfig, mesh, B: int, S: int) -> Optional[Dict]:
    """The expert-parallel layout of a (B, S) input on ``mesh``, or None
    where the reference falls back to ``_moe_dispatch``, in its order: no
    mesh; no "model" axis; E % EP; EP == 1; B % n_dp or S % EP."""
    m = cfg.moe
    if (mesh is None or "model" not in mesh.shape
            or m.num_experts % mesh.shape["model"]):
        return None
    EP = mesh.shape["model"]
    if EP == 1:
        return None
    dp = act_sharding.dp(mesh)
    dp_t = dp if isinstance(dp, tuple) else (dp,)
    dp_sizes = tuple(mesh.shape[a] for a in dp_t)
    n_dp = math.prod(dp_sizes)
    if B % n_dp or S % EP:
        return None
    E_loc = m.num_experts // EP
    T_loc = (B // n_dp) * (S // EP)
    c_send = max(8, -(-int(T_loc * m.top_k / EP * m.capacity_factor) // 8)
                 * 8)
    c_exp = max(8, -(-int(EP * c_send / E_loc * m.capacity_factor) // 8)
                * 8)
    return {"EP": EP, "E_loc": E_loc, "dp_sizes": dp_sizes, "n_dp": n_dp,
            "T_loc": T_loc, "c_send": c_send, "c_exp": c_exp}


def to_shards(x, lay: Dict):
    """(B, S, D) -> (G, T_loc, D): shard (dp i, rank r) holds x[i-th batch
    block, r-th sequence block], its tokens in (b, s) order."""
    B, S, D = x.shape
    n_dp, EP = lay["n_dp"], lay["EP"]
    return x.reshape(n_dp, B // n_dp, EP, S // EP, D).transpose(1, 2).reshape(
        n_dp * EP, lay["T_loc"], D)


def from_shards(y, lay: Dict, B: int, S: int):
    """The inverse of :func:`to_shards`."""
    n_dp, EP = lay["n_dp"], lay["EP"]
    D = y.shape[-1]
    return y.reshape(n_dp, EP, B // n_dp, S // EP, D).transpose(1, 2).reshape(
        B, S, D)


def route(cfg: ModelConfig, p, xs, lay: Dict):
    """Each shard's router on its tokens xs (G, n, D) in the compute dtype
    -> (top_p (G, n, K), top_idx (G, n, K), aux): the float32 gate, its
    top k by a stable descending sort (``jax.lax.top_k``'s order of ties),
    renormalised; each shard's Switch load-balance aux averaged over
    "model", then over each dp axis (a plain mean over equal shards)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    G, n, _ = xs.shape
    probs = torch.softmax(xs.float() @ p["w_router"].float(), dim=-1)
    top_p, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_idx = top_p[..., :K], top_idx[..., :K]
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-9)
    counts = torch.zeros((G, E), dtype=torch.float32, device=xs.device)
    counts.scatter_add_(1, top_idx.reshape(G, n * K),
                        torch.ones((G, n * K), device=xs.device))
    f_e = counts / n                          # the share routed, per shard
    p_e = probs.mean(1)
    aux = E * (f_e * p_e).sum(-1) * m.router_aux_weight        # (G,)
    aux = aux.view(lay["dp_sizes"] + (lay["EP"],)).mean(-1)
    for _ in lay["dp_sizes"]:
        aux = aux.mean(0)
    return top_p, top_idx, aux


def exchange(cfg: ModelConfig, p, xs, top_p, top_idx, lay: Dict,
             info: Optional[Dict] = None):
    """The two hops and the experts for routed shards -> y (G, n, D) in the
    compute dtype.  ``info`` (a dict) receives each pair's fate, (G, n, K)
    bool: ``"sent"`` (kept at the first hop) and ``"kept"`` (kept at both)."""
    m = cfg.moe
    K = m.top_k
    G, n, D = xs.shape
    EP, E_loc, n_dp = lay["EP"], lay["E_loc"], lay["n_dp"]
    c_send, c_exp = lay["c_send"], lay["c_exp"]
    cd = xs.dtype
    dev = xs.device
    flat_e = top_idx.reshape(G, n * K)
    flat_t = torch.arange(n, device=dev).repeat_interleave(K)
    flat_p = top_p.reshape(G, n * K).to(cd)
    plan1 = _plan(flat_e // E_loc, EP, c_send)       # to the owning rank
    send = _pack(plan1, xs[:, flat_t], EP, c_send)   # (G, EP, c_send, D)
    send_eid = _pack(plan1, flat_e % E_loc, EP, c_send)

    def all_to_all(t):
        # (dp, source rank, destination rank, ...) -> (dp, destination,
        # source, ...): what each destination receives, source-major; every
        # shard's buckets are its bytes sent
        cost_analysis.collective("all-to-all", t)
        return t.reshape((n_dp, EP, EP) + t.shape[2:]).transpose(1, 2)

    rx = all_to_all(send).reshape(G, EP * c_send, D)
    re = all_to_all(send_eid).reshape(G, EP * c_send)
    plan2 = _plan(re, E_loc, c_exp)
    buf = _pack(plan2, rx, E_loc, c_exp)              # (G, E_loc, c_exp, D)
    # shard (i, r) holds experts r E_loc ..: one product per expert over
    # the rows of every dp group
    E = EP * E_loc
    hb = buf.reshape(n_dp, E, c_exp, D).transpose(0, 1).reshape(
        E, n_dp * c_exp, D)
    h = F.silu(torch.bmm(hb, p["we1"].to(cd))) * torch.bmm(
        hb, p["we3"].to(cd))
    ob = torch.bmm(h, p["we2"].to(cd))
    del hb, h
    out_buf = ob.reshape(E, n_dp, c_exp, D).transpose(0, 1).reshape(
        G, E_loc, c_exp, D)
    back = _unpack(plan2, out_buf, EP * c_send).reshape(G, EP, c_send, D)
    contrib = _unpack(plan1, all_to_all(back).reshape(G, EP, c_send, D),
                      n * K)
    w = (contrib * flat_p[..., None]).view(G, n, K, D)
    # the reference's scatter-add meets a token's terms in (t, k) order,
    # rounding after each add
    y = w[:, :, 0]
    for k in range(1, K):
        y = y + w[:, :, k]
    if info is not None:
        keep2 = _unpack(plan2, torch.ones((G, E_loc, c_exp), dtype=torch.bool,
                                          device=dev), EP * c_send)
        info["sent"] = _unpack(plan1, torch.ones((G, EP, c_send),
                                                 dtype=torch.bool,
                                                 device=dev),
                               n * K).view(G, n, K)
        info["kept"] = _unpack(plan1, all_to_all(keep2.reshape(
            G, EP, c_send)).reshape(G, EP, c_send), n * K).view(G, n, K)
    if m.num_shared_experts and "shared" in p:
        sp = p["shared"]
        xf = xs.reshape(G * n, D)
        hs = F.silu(xf @ sp["w1"].to(cd)) * (xf @ sp["w3"].to(cd))
        y = y + (hs @ sp["w2"].to(cd)).view(G, n, D)
    return y


def apply_moe_expert_parallel(cfg: ModelConfig, p, x,
                              info: Optional[Dict] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in the compute dtype, aux) under the
    active mesh; without a layout (:func:`layout`) the single dispatch
    ``moe._moe_dispatch``, as the reference falls back.  ``info``: see
    :func:`exchange` (and ``"layout"``)."""
    from repro_torch.models.moe import _moe_dispatch
    B, S, _ = x.shape
    lay = layout(cfg, act_sharding.current_mesh(), B, S)
    if lay is None:
        return _moe_dispatch(cfg, p, x)
    xs = to_shards(x, lay).to(dtype_of(cfg.compute_dtype))
    top_p, top_idx, aux = route(cfg, p, xs, lay)
    if info is not None:
        info["layout"] = lay
    y = exchange(cfg, p, xs, top_p, top_idx, lay, info)
    return from_shards(y, lay, B, S), aux
