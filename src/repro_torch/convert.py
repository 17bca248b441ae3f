"""Carry state from the reference package into the port, as numpy data.

``params_from_jax`` turns the reference's MLP parameter tree
``{"actor": [{"w", "b"}, ...], "critic": [...], "log_std"}`` (leaves as
numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) into an
:class:`~repro_torch.drl.networks.ActorCritic`.  The reference computes
``x @ w`` with ``w`` shaped ``(in, out)``; ``nn.Linear`` holds ``(out,
in)``, so weights are transposed.  ``flow_state_from_numpy`` and
``geom_arrays_from_numpy`` carry a flow state and the geometry fields.
``model_params_from_jax`` carries a language model's parameter tree.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.cfd import solver
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.drl import networks
from repro_torch.models.layers import dtype_of


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32),
                        device=resolve_device(device))


def params_from_jax(tree: Mapping, device="cuda") -> networks.ActorCritic:
    device = resolve_device(device)
    actor, critic = tree["actor"], tree["critic"]
    obs_dim, hidden = np.shape(actor[0]["w"])
    cfg = networks.PolicyConfig(obs_dim=int(obs_dim),
                                act_dim=int(np.shape(tree["log_std"])[0]),
                                hidden=int(hidden), depth=len(actor) - 1)
    model = networks.ActorCritic(cfg)
    for layers, src in ((model.actor, actor), (model.critic, critic)):
        if len(layers) != len(src):
            raise ValueError(f"layer count mismatch: {len(layers)} vs "
                             f"{len(src)}")
        for lin, lyr in zip(layers, src):
            w = np.asarray(lyr["w"])
            if w.T.shape != tuple(lin.weight.shape):
                raise ValueError(f"weight shape {w.shape} does not fit "
                                 f"{tuple(lin.weight.shape)} transposed")
            with torch.no_grad():
                lin.weight.copy_(_t(w.T, "cpu"))
                lin.bias.copy_(_t(lyr["b"], "cpu"))
    with torch.no_grad():
        model.log_std.copy_(_t(tree["log_std"], "cpu"))
    return model.to(device)


def flow_state_from_numpy(u, v, p, device="cuda") -> solver.FlowState:
    return solver.FlowState(_t(u, device), _t(v, device), _t(p, device))


def geom_arrays_from_numpy(fields: Sequence, device="cuda"
                           ) -> solver.GeomArrays:
    """``fields``: the geometry arrays in ``GeomArrays`` order (e.g. the
    reference's ``GeomArrays`` as numpy), the eleven single-field ones or
    all fifteen with the per-body fields (``None`` entries stay absent)."""
    vals = list(fields)
    if len(vals) not in (11, len(solver.GeomArrays._fields)):
        raise ValueError(f"expected 11 or {len(solver.GeomArrays._fields)} "
                         f"geometry fields, got {len(vals)}")
    return solver.GeomArrays(*(None if a is None else _t(a, device)
                               for a in vals))


def params_to_numpy(model: networks.ActorCritic) -> dict:
    """The module as the reference's tree of numpy arrays."""
    def layers(ms: Sequence):
        return [{"w": m.weight.detach().cpu().numpy().T.copy(),
                 "b": m.bias.detach().cpu().numpy().copy()} for m in ms]
    return {"actor": layers(model.actor), "critic": layers(model.critic),
            "log_std": model.log_std.detach().cpu().numpy().copy()}


def model_params_from_jax(cfg: ModelConfig, tree: Mapping, device="cuda"
                          ) -> dict:
    """The reference's language-model parameter tree (nested dicts, leaves
    as numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``; blocks
    stacked on a leading layer axis) as the port's dict of tensors, each
    leaf in its own dtype.  A bfloat16 leaf arrives as an ``ml_dtypes``
    array, which torch cannot read: it goes through float32, and back to
    bfloat16 exactly."""
    device = resolve_device(device)
    embed = np.shape(tree["embed"])
    if embed != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embed {embed} does not fit {cfg.name}: expected "
                         f"{(cfg.vocab_padded, cfg.d_model)}")
    n_layers = np.shape(tree["blocks"]["ln1"]["scale"])[0]
    if n_layers != cfg.num_layers:
        raise ValueError(f"{n_layers} stacked layers, {cfg.name} has "
                         f"{cfg.num_layers}")

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        a = np.asarray(node)
        t = torch.tensor(a.astype(np.float32), device=device)
        return t.to(dtype_of(a.dtype.name))

    return conv(tree)
