"""Carry state from the reference package into the port, as numpy data.

``params_from_jax`` turns the reference's policy parameter tree (leaves as
numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) into the port's
module: the MLP's ``{"actor": [{"w", "b"}, ...], "critic": [...],
"log_std"}`` into an :class:`~repro_torch.drl.networks.ActorCritic`, the
attention policy's (``embed``, ``blocks``, ``ln_f``, ``actor``, ``critic``,
``log_std``; dispatched on ``"embed" in tree`` as the reference's
``is_attention`` does) into an
:class:`~repro_torch.drl.networks.AttentionActorCritic`.  The reference
computes ``x @ w`` with ``w`` shaped ``(in, out)``; ``nn.Linear`` holds
``(out, in)``, so those weights are transposed; the factored ``(d, heads,
dh)`` q/k/v weights carry across as they are.  ``params_to_numpy`` is the
way back.  ``train_state_from_numpy`` carries a reference run's training
state (``repro.drl.train_state.to_tree`` content) into the port's
``TrainState``.  ``flow_state_from_numpy`` and ``geom_arrays_from_numpy``
carry a flow state and the geometry fields; ``model_params_from_jax`` a
language model's parameter tree.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.cfd import grid as grid_mod
from repro_torch.cfd import solver
from repro_torch.cfd.env import EnvState
from repro_torch.cfd.scenarios import ScenarioParams
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.drl import networks
from repro_torch.drl.train_state import HISTORY_FIELDS, TrainState
from repro_torch.models.layers import dtype_of


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32),
                        device=resolve_device(device))


def _copy(param: torch.Tensor, a, what: str) -> None:
    a = np.asarray(a, dtype=np.float32)
    if a.shape != tuple(param.shape):
        raise ValueError(f"{what}: shape {a.shape} does not fit "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.tensor(a))


def _load_linear(lin: torch.nn.Linear, lyr: Mapping, what: str) -> None:
    """A reference ``{"w" (in, out), "b"}`` layer into an ``nn.Linear``."""
    _copy(lin.weight, np.asarray(lyr["w"]).T, f"{what}.w (transposed)")
    if lin.bias is not None:
        _copy(lin.bias, lyr["b"], f"{what}.b")


def _load_mlp(layers, src: Sequence, what: str) -> None:
    if len(layers) != len(src):
        raise ValueError(f"{what}: layer count mismatch: {len(layers)} vs "
                         f"{len(src)}")
    for i, (lin, lyr) in enumerate(zip(layers, src)):
        _load_linear(lin, lyr, f"{what}[{i}]")


def _load_ln(ln: networks.LayerNorm, p: Mapping, what: str) -> None:
    _copy(ln.g, p["g"], f"{what}.g")
    _copy(ln.b, p["b"], f"{what}.b")


def params_from_jax(tree: Mapping, device="cuda") -> torch.nn.Module:
    """The reference's policy tree as the port's module.  The MLP's
    widths come from its layers; the attention policy's weights do not
    depend on the probe count, so its config keeps the default
    ``obs_dim``."""
    device = resolve_device(device)
    act_dim = int(np.shape(tree["log_std"])[0])
    if "embed" in tree:
        blocks = tree["blocks"]
        d = int(np.shape(tree["embed"]["w"])[1])
        cfg = networks.PolicyConfig(
            act_dim=act_dim, policy="attention",
            d_model=d, heads=int(np.shape(blocks[0]["wq"])[1]),
            kv_heads=int(np.shape(blocks[0]["wk"])[1]), layers=len(blocks))
        model = networks.AttentionActorCritic(cfg)
        _load_linear(model.embed, tree["embed"], "embed")
        for i, (blk, src) in enumerate(zip(model.blocks, blocks)):
            what = f"blocks[{i}]"
            _load_ln(blk.ln1, src["ln1"], f"{what}.ln1")
            for name in ("wq", "wk", "wv"):
                _copy(getattr(blk, name), src[name], f"{what}.{name}")
            _load_linear(blk.wo, {"w": src["wo"]}, f"{what}.wo")
            _load_ln(blk.ln2, src["ln2"], f"{what}.ln2")
            _load_mlp(blk.mlp, src["mlp"], f"{what}.mlp")
        _load_ln(model.ln_f, tree["ln_f"], "ln_f")
    else:
        obs_dim, hidden = np.shape(tree["actor"][0]["w"])
        cfg = networks.PolicyConfig(obs_dim=int(obs_dim), act_dim=act_dim,
                                    hidden=int(hidden),
                                    depth=len(tree["actor"]) - 1)
        model = networks.ActorCritic(cfg)
    _load_mlp(model.actor, tree["actor"], "actor")
    _load_mlp(model.critic, tree["critic"], "critic")
    _copy(model.log_std, tree["log_std"], "log_std")
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


def params_to_numpy(model: torch.nn.Module) -> dict:
    """The module as the reference's tree of numpy arrays."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    def linear(m):
        out = {"w": arr(m.weight).T.copy()}
        if m.bias is not None:
            out["b"] = arr(m.bias)
        return out

    def ln(m):
        return {"g": arr(m.g), "b": arr(m.b)}

    tree = {"actor": [linear(m) for m in model.actor],
            "critic": [linear(m) for m in model.critic],
            "log_std": arr(model.log_std)}
    if networks.is_attention(model):
        tree["embed"] = linear(model.embed)
        tree["blocks"] = [{"ln1": ln(b.ln1), "wq": arr(b.wq),
                           "wk": arr(b.wk), "wv": arr(b.wv),
                           "wo": linear(b.wo)["w"], "ln2": ln(b.ln2),
                           "mlp": [linear(m) for m in b.mlp]}
                          for b in model.blocks]
        tree["ln_f"] = ln(model.ln_f)
    return tree


def train_state_from_numpy(tree: Mapping, device="cuda", *,
                           seed: int = 0) -> TrainState:
    """The reference's training state as the port's ``TrainState``.

    ``tree`` is ``repro.drl.train_state.to_tree``'s content as numpy (for
    a reference checkpoint: ``repro.ckpt.checkpoint.restore`` then
    ``repro.drl.train_state._nest``): ``params``, the Adam ``opt_state``
    (``m`` / ``v`` trees mirroring the params), ``step``, ``episode``,
    ``history``, the batched ``env_state`` and ``obs``.  The moments come
    out in the port's ``model.parameters()`` order, transposed where the
    params are.  Integer counters and ``geom_id`` become int64; an env
    state written before the multi-body layer (no ``geom_id`` /
    ``act_mask``) gets the cylinder's index and all-live action slots.

    The reference's PRNG key cannot carry into a ``torch.Generator`` (other
    generators, other streams), so the state's generator is
    ``torch.Generator().manual_seed(seed)``'s: pass the run's
    ``TrainConfig.seed``.  The continued run draws other rollout noise and
    PPO permutations than the reference would have."""
    device = resolve_device(device)
    model = params_from_jax(tree["params"], "cpu")
    moments = {k: [p.detach().to(device) for p in
                   params_from_jax(tree["opt_state"][k], "cpu").parameters()]
               for k in ("m", "v")}

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.tensor(np.asarray(a, np.int64), device=device)

    def flow(d):
        return solver.FlowState(f32(d["u"]), f32(d["v"]), f32(d["p"]))

    env_state = None
    if "env_state" in tree:
        st = tree["env_state"]
        scn = dict(st["scn"])
        t = np.asarray(st["t"])
        jv = np.asarray(st["jet_vel"])
        if scn.get("geom_id") is None:
            scn["geom_id"] = np.full(t.shape,
                                     grid_mod.geometry_index("cylinder"))
        if scn.get("act_mask") is None:
            a = jv.shape[-1] if jv.ndim > t.ndim else 1
            scn["act_mask"] = np.ones(t.shape + (a,), np.float32)
        env_state = EnvState(
            flow=flow(st["flow"]), jet_vel=f32(jv), t=i64(t),
            scn=ScenarioParams(**{k: i64(v) if k == "geom_id" else f32(v)
                                  for k, v in scn.items()}),
            reset_flow=flow(st["reset_flow"]) if "reset_flow" in st
            else None)
    return TrainState(
        params={k: v.to(device) for k, v in model.state_dict().items()},
        opt_state=moments,
        rng=torch.Generator().manual_seed(seed).get_state(),
        step=int(np.asarray(tree["step"])),
        episode=int(np.asarray(tree["episode"])),
        env_state=env_state,
        obs=f32(tree["obs"]) if "obs" in tree else None,
        history={k: np.asarray(tree.get("history", {}).get(k, ()),
                               np.float64) for k in HISTORY_FIELDS})


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
