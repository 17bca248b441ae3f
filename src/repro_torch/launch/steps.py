"""The language model's step builders: ``make_train_step``,
``make_prefill_step`` and ``make_serve_step``, with ``make_opt``,
``abstract_params`` and the mesh's specs.

Port of ``repro.launch.steps``:

  train   -> train_step(params, opt_state, step, batch)
             -> (params, opt_state, step + 1, {"loss"})
  prefill -> prefill_step(params, tokens, frontend_embeds=None)
             -> (logits, cache)
  decode  -> serve_step(params, cache, token, pos) -> (logits, cache)

A train step runs the reference mixers, as the reference's does: jax
cannot differentiate the reference's Pallas kernels (``pallas_call``'s
JVP rule asserts), and the port's kernels are forward only, so
``backend="pallas"`` is refused when the step is built.  The step takes
the gradients of ``lm_loss`` with ``torch.autograd.grad`` over the
parameter leaves, in microbatches clamped as the reference clamps them,
accumulated in float32 for AdamW and in bfloat16 for Adafactor, then
divided by the microbatch count; ``cfg.remat`` is honoured by the model.
The parameters and the optimizer state are updated in place and returned
(the reference donates their buffers): a caller that needs the old ones
clones them first.

Parameter leaves are taken in the order of the reference's
``jax.tree.leaves`` (dict keys sorted), so an optimizer state list lines
up leaf for leaf with the reference's tree (``convert.opt_state_from_jax``).

Each step takes the reference's ``mesh`` (a plan-path ``Mesh``, an
``AbstractMesh``, or None) and runs under ``activation_mesh(mesh)``, on
one controller: the model computes what the reference's mesh path
computes (``models/model.py``), the train step clamps its microbatches by
the data-parallel width and constrains each gradient leaf to its
parameter's spec.  The specs of a step's arguments are the reference's
(``fsdp_axes_for``, ``opt_state_specs``, ``batch_structs``,
``cache_specs``), each leaf's spec equal to the reference's for that leaf
in the port's own layout; ``lowering_for`` returns a step and its
arguments as meta tensors with their specs, which ``launch/dryrun.py``
counts per device.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import act_sharding
from repro_torch.models import frontend as fe_mod
from repro_torch.models import model as M
from repro_torch.models.attention import resolve_backend
from repro_torch.models.sharding import (P, axis_size, batch_spec,
                                         cache_leaf_spec, dp_axes,
                                         param_specs)
from repro_torch.optim.optimizers import make_optimizer


def abstract_params(cfg: ModelConfig) -> Dict:
    """The parameter tree's shapes and dtypes, on the "meta" device (no
    memory)."""
    return M.init_params(cfg, device="meta")


def fsdp_axes_for(cfg: ModelConfig, mesh) -> Tuple[str, ...]:
    """The FSDP axes: ("pod", "data") for a dense Adafactor config (the
    100B+ ones) on a mesh with a pod axis, else ("data",); MoE configs keep
    their parameters replicated across pods."""
    if (mesh is not None and "pod" in mesh.shape
            and cfg.optimizer == "adafactor" and cfg.moe is None):
        return ("pod", "data")
    return ("data",)


def make_opt(cfg: ModelConfig):
    kw = {}
    if cfg.optimizer == "adafactor":
        # 100B+ archs: bf16 update direction (see optimizers.adafactor)
        kw["update_dtype"] = torch.bfloat16
    return make_optimizer(cfg.optimizer, 1e-4, max_grad_norm=1.0, **kw)


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``("a/b/c", leaf)`` of a nested dict, in ``jax.tree.leaves`` order
    (keys sorted)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves_with_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict in ``jax.tree.leaves`` order."""
    return [v for _, v in leaves_with_paths(tree)]


def abstract_opt_state(cfg: ModelConfig, params_shape):
    """``make_opt(cfg)``'s state for the parameter tree ``params_shape``, in
    the port's layout (AdamW ``{"m": [...], "v": [...]}``, Adafactor a list
    of ``{"vr", "vc"}`` / ``{"v"}``, in ``param_leaves`` order), on the
    meta device (``params_shape``'s, as ``abstract_params`` gives it)."""
    return make_opt(cfg).init(param_leaves(params_shape))


def _leaf_specs(mesh, params_shape, fsdp_axes=("data",)) -> List[P]:
    """The specs of a parameter tree's leaves, in ``param_leaves`` order."""
    return [s for _, s in leaves_with_paths(param_specs(mesh, params_shape,
                                                        fsdp_axes))]


def opt_state_specs(mesh, params_shape, opt_shape, fsdp_axes=("data",)):
    """The specs of an optimizer state ``opt_shape`` (the port's layout,
    as :func:`abstract_opt_state` gives it), each the reference's for the
    same leaf: AdamW's m / v mirror the parameter; Adafactor's v mirrors
    it, vr drops its last dim and vc its second-to-last; a spec that does
    not fit the leaf's rank becomes ``P()``."""
    pspecs = _leaf_specs(mesh, params_shape, fsdp_axes)

    def fit(spec, leaf):
        return spec if len(spec) == leaf.dim() else P()

    if isinstance(opt_shape, dict):                         # AdamW
        return {k: [fit(s, v) for s, v in zip(pspecs, opt_shape[k])]
                for k in opt_shape}
    out = []
    for base, st in zip(pspecs, opt_shape):                 # Adafactor
        d = {}
        for stat, leaf in st.items():
            if stat == "v":
                d[stat] = fit(base, leaf)
            elif stat == "vr" and len(base) >= 1:
                d[stat] = fit(P(*base[:-1]), leaf)
            elif stat == "vc" and len(base) >= 2:
                d[stat] = fit(P(*(tuple(base[:-2]) + (base[-1],))), leaf)
            else:
                d[stat] = P()
        out.append(d)
    return out


def microbatches(requested: int, batch: int, n_dp: int = 1) -> int:
    """The reference's clamp: halve the microbatch count until it divides
    the batch and each microbatch divides the data-parallel ways."""
    m = requested
    while m > 1 and (batch % m or (batch // m) % n_dp):
        m //= 2
    return m


def make_train_step(cfg: ModelConfig, mesh=None,
                    backend: Optional[str] = None) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, {"loss"})``; ``batch`` holds ``tokens`` and ``labels`` (B, S)
    (tensors, or numpy arrays moved to the parameters' device) and may
    hold a ``mask`` and a frontend config's ``frontend_embeds`` (B, T,
    frontend_dim); every key is cut into the same microbatches.  Under
    ``mesh`` the microbatch count is clamped so that each microbatch
    divides the data-parallel width, and each gradient leaf is
    constrained to its parameter's spec."""
    backend = resolve_backend(backend)
    if backend == "pallas":
        raise NotImplementedError(
            "make_train_step(backend='pallas'): the reference cannot "
            "differentiate its Pallas kernels (jax's pallas_call JVP rule "
            "asserts) and the port's kernels are forward only, so training "
            "runs the reference mixers: use backend='reference' (the "
            "default)")
    M.check_supported(cfg)
    opt = make_opt(cfg)
    accum_dtype = (torch.float32 if cfg.optimizer == "adamw"
                   else torch.bfloat16)
    gspecs = (_leaf_specs(mesh, abstract_params(cfg),
                          fsdp_axes_for(cfg, mesh))
              if mesh is not None else None)
    n_dp = axis_size(mesh, dp_axes(mesh)) if mesh is not None else 1

    def constrain_grads(grads):
        if gspecs is not None:
            for g, spec in zip(grads, gspecs):
                act_sharding.constrain_to(g, spec)
        return grads

    def grads_of(params, leaves, mb):
        loss, _ = M.lm_loss(cfg, params, mb, backend=backend)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as jax
        # gives it
        return loss.detach(), constrain_grads(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)])

    def train_step(params, opt_state, step, batch):
        with act_sharding.activation_mesh(mesh):
            return _train_step(params, opt_state, step, batch)

    def _train_step(params, opt_state, step, batch):
        leaves = param_leaves(params)
        dev = leaves[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        n_mb = microbatches(cfg.train_microbatches, B, n_dp)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if n_mb == 1:
                loss, grads = grads_of(params, leaves, batch)
            else:
                b = B // n_mb
                grads = [torch.zeros_like(p, dtype=accum_dtype)
                         for p in leaves]
                loss = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(n_mb):
                    mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    l, g = grads_of(params, leaves, mb)
                    with torch.no_grad():
                        for acc, x in zip(grads, g):
                            acc.add_(x.to(accum_dtype))
                    constrain_grads(grads)
                    del g
                    loss = loss + l
                with torch.no_grad():
                    for acc in grads:
                        acc.div_(n_mb)
                loss = loss / n_mb
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            opt.update(grads, opt_state, leaves, step, donate=True)
        return params, opt_state, step + 1, {"loss": loss}

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      backend: Optional[str] = None) -> Callable:
    """``prefill_step(params, tokens, frontend_embeds=None) -> (logits (B,
    V), cache)`` under ``mesh``.  Prefill always runs the reference mixers,
    as the reference's does (the flash kernel serves training's causal
    forward); ``backend`` is validated all the same, so an unknown
    selection fails here."""
    resolve_backend(backend)

    def prefill_step(params, tokens, frontend_embeds=None):
        with act_sharding.activation_mesh(mesh):
            return M.prefill(cfg, params, tokens,
                             frontend_embeds=frontend_embeds)
    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits (B, V), cache)``:
    one ``decode_step`` under ``mesh``, the cache updated in place."""
    def serve_step(params, cache, token, pos):
        with act_sharding.activation_mesh(mesh):
            return M.decode_step(cfg, params, cache, token, pos)
    return serve_step


# ---------------------------------------------------------------------------
# a step's arguments as meta tensors with their specs (the dry run's input)
# ---------------------------------------------------------------------------

class Struct(NamedTuple):
    """An argument's shape and dtype (a meta tensor) and its spec: the
    counterpart of a ``jax.ShapeDtypeStruct`` with a sharding."""
    meta: torch.Tensor
    spec: P


def _struct(shape, dtype, spec=P()) -> Struct:
    return Struct(torch.empty(shape, dtype=dtype, device="meta"), spec)


def batch_structs(cfg: ModelConfig, shape: InputShape, mesh) -> Dict:
    """The data arguments of ``shape``'s step: tokens and labels (train),
    tokens (prefill), a frontend's float32 embeddings, or a decode's token
    (B, 1) and position (), int32, the batch over the dp axes where they
    divide it."""
    B, S = shape.global_batch, shape.seq_len
    b = batch_spec(mesh, B)[0]
    out: Dict[str, Struct] = {}
    if shape.kind in ("train", "prefill"):
        out["tokens"] = _struct((B, S), torch.int32, P(b, None))
        if shape.kind == "train":
            out["labels"] = _struct((B, S), torch.int32, P(b, None))
        if cfg.frontend:
            t = fe_mod.num_frontend_tokens(cfg, S)
            out["frontend_embeds"] = _struct(
                (B, t, fe_mod.frontend_dim(cfg)), torch.float32,
                P(b, None, None))
    else:
        out["token"] = _struct((B, 1), torch.int32, P(b, None))
        out["pos"] = _struct((), torch.int32)
    return out


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq: int):
    """(the specs of ``init_cache(cfg, batch, seq)``'s leaves by key, the
    cache as meta tensors)."""
    cache = M.init_cache(cfg, batch, seq, device="meta")
    return ({k: cache_leaf_spec(mesh, k, v.shape) for k, v in cache.items()},
            cache)


def cache_structs(cfg: ModelConfig, mesh, batch: int, seq: int) -> Dict:
    specs, cache = cache_specs(cfg, mesh, batch, seq)
    return {k: Struct(v, specs[k]) for k, v in cache.items()}


def _tree_structs(tree, specs):
    if isinstance(tree, dict):
        return {k: _tree_structs(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_structs(v, s) for v, s in zip(tree, specs)]
    return Struct(tree, specs)


def lowering_for(cfg: ModelConfig, shape: InputShape, mesh):
    """(the step of ``shape.kind`` under ``mesh``, its arguments as
    :class:`Struct` trees): train (params, opt_state, step, batch), prefill
    (params, tokens[, frontend_embeds]), decode (params, cache, token,
    pos)."""
    params_shape = abstract_params(cfg)
    fsdp = fsdp_axes_for(cfg, mesh)
    params = _tree_structs(params_shape, param_specs(mesh, params_shape,
                                                     fsdp))
    data = batch_structs(cfg, shape, mesh)
    if shape.kind == "train":
        opt_shape = abstract_opt_state(cfg, params_shape)
        opt = _tree_structs(opt_shape, opt_state_specs(
            mesh, params_shape, opt_shape, fsdp))
        return (make_train_step(cfg, mesh),
                (params, opt, _struct((), torch.int32), data))
    if shape.kind == "prefill":
        args = (params, data["tokens"])
        if "frontend_embeds" in data:
            args += (data["frontend_embeds"],)
        return make_prefill_step(cfg, mesh), args
    return (make_serve_step(cfg, mesh),
            (params, cache_structs(cfg, mesh, shape.global_batch,
                                   shape.seq_len),
             data["token"], data["pos"]))
