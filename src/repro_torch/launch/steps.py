"""The language model's step builders: ``make_train_step``,
``make_prefill_step`` and ``make_serve_step``, with ``make_opt`` and
``abstract_params``.

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

There is no mesh argument yet: ``opt_state_specs``, ``batch_structs``,
``cache_specs`` and ``lowering_for`` wait with the mesh layer
(``ROADMAP.md`` §1 item 5.8).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.attention import resolve_backend
from repro_torch.optim.optimizers import make_optimizer


def abstract_params(cfg: ModelConfig) -> Dict:
    """The parameter tree's shapes and dtypes, on the "meta" device (no
    memory)."""
    return M.init_params(cfg, device="meta")


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


def microbatches(requested: int, batch: int, n_dp: int = 1) -> int:
    """The reference's clamp: halve the microbatch count until it divides
    the batch and each microbatch divides the data-parallel ways."""
    m = requested
    while m > 1 and (batch % m or (batch // m) % n_dp):
        m //= 2
    return m


def make_train_step(cfg: ModelConfig,
                    backend: Optional[str] = None) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, {"loss"})``; ``batch`` holds ``tokens`` and ``labels`` (B, S)
    (tensors, or numpy arrays moved to the parameters' device) and may
    hold a ``mask`` and a frontend config's ``frontend_embeds`` (B, T,
    frontend_dim); every key is cut into the same microbatches."""
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

    def grads_of(params, leaves, mb):
        loss, _ = M.lm_loss(cfg, params, mb, backend=backend)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as jax
        # gives it
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state, step, batch):
        leaves = param_leaves(params)
        dev = leaves[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        n_mb = microbatches(cfg.train_microbatches, B)
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


def make_prefill_step(cfg: ModelConfig,
                      backend: Optional[str] = None) -> Callable:
    """``prefill_step(params, tokens, frontend_embeds=None) -> (logits (B,
    V), cache)``.  Prefill always runs the reference mixers, as the
    reference's does (the flash kernel serves training's causal forward);
    ``backend`` is validated all the same, so an unknown selection fails
    here."""
    resolve_backend(backend)

    def prefill_step(params, tokens, frontend_embeds=None):
        return M.prefill(cfg, params, tokens,
                         frontend_embeds=frontend_embeds)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits (B, V), cache)``:
    one ``decode_step``, the cache updated in place."""
    def serve_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)
    return serve_step
