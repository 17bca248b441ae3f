"""Resumable training state: the one bundle ``train()`` checkpoints and
restores.

Port of ``repro.drl.train_state``.  A ``TrainState`` carries everything a
crash would otherwise lose: the model's ``state_dict()``, the Adam moments
(lists in ``model.parameters()`` order), the rollout generator's state
(``torch.Generator.get_state()``, a uint8 tensor: the port's counterpart of
the reference's PRNG key carry, from which every rollout draw and PPO
permutation of the remaining episodes comes), the PPO minibatch step (Adam
bias correction), the episode counter, the batched env state (flow, the
warmup flow a quarantine resets to, the per-env ``ScenarioParams`` with
``geom_id``) and its observations, so a resume skips the warmup, and the
per-episode history.

Serialization goes through ``repro_torch.ckpt.checkpoint`` as a plain dict
tree (NamedTuples become dicts and are rebuilt on load), so the manifest
alone rebuilds the state.

The manifest metadata records the run fingerprint (grid, scenarios,
n_envs, horizon, policy, framework); ``check_resume_compatible`` raises an
actionable ``CheckpointError`` on any mismatch that would change the run.
``framework`` is strict: a torch state never resumes as a JAX one, nor a
JAX one as a torch one (``repro_torch.convert.train_state_from_numpy``
carries a reference state across explicitly).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.cfd.env import EnvState
from repro_torch.cfd.scenarios import ScenarioParams
from repro_torch.cfd.solver import FlowState
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.device import resolve_device

TRAIN_STATE_SCHEMA = "repro_torch.train_state/v1"
HISTORY_FIELDS = ("reward", "cd", "cl", "wall", "quarantines", "grad_skips")

# metadata fields that must match between checkpoint and config: the
# reference's, plus the framework that wrote the state
RESUME_STRICT_FIELDS = ("n_envs", "obs_dim", "grid", "horizon",
                        "steps_per_action", "scenarios", "policy",
                        "framework")


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the model's state_dict()
    opt_state: Dict[str, List[torch.Tensor]]   # Adam {"m": [...], "v": [...]}
    rng: torch.Tensor                 # uint8 generator state BEFORE the
    #                                   next episode
    step: int                         # PPO minibatch counter
    episode: int                      # episodes completed
    env_state: Any                    # batched EnvState, a plain tensor
    #                                   (engine-level loops) or None
    obs: Optional[torch.Tensor]       # batched observations (or None)
    history: Dict[str, np.ndarray]    # per-episode logs, length == episode


# ---------------------------------------------------------------------------
# (de)serialization
# ---------------------------------------------------------------------------

def to_tree(ts: TrainState) -> Dict[str, Any]:
    """TrainState -> plain dict tree (its leaves still the live tensors:
    ``AsyncCheckpointer.save`` snapshots them)."""
    tree: Dict[str, Any] = {
        "params": dict(ts.params),
        "opt_state": {k: list(v) for k, v in ts.opt_state.items()},
        "rng": ts.rng,
        "step": np.asarray(ts.step, np.int64),
        "episode": np.asarray(ts.episode, np.int64),
        "history": {k: np.asarray(v) for k, v in ts.history.items()},
    }
    st = ts.env_state
    if isinstance(st, EnvState):
        tree["env_state"] = {"flow": st.flow._asdict(),
                             "jet_vel": st.jet_vel, "t": st.t,
                             "scn": st.scn._asdict()}
        if st.reset_flow is not None:      # sentinel quarantine flow
            tree["env_state"]["reset_flow"] = st.reset_flow._asdict()
    elif st is not None:
        # engine-level loops (toy envs, tests) carry a plain tensor
        tree["env_state"] = st
    if ts.obs is not None:
        tree["obs"] = ts.obs
    return tree


def _nest(arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """'a/b/0/c' path keys -> nested dicts; all-integer levels -> lists."""
    root: Dict[str, Any] = {}
    for path, arr in arrays.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def conv(n):
        if not isinstance(n, dict):
            return n
        out = {k: conv(v) for k, v in n.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(out, key=int)
            if [int(i) for i in idx] == list(range(len(idx))):
                return [out[i] for i in idx]
        return out

    return conv(root)


def from_tree(tree: Dict[str, Any], device="cuda") -> TrainState:
    """Rebuild a TrainState from a ``to_tree`` dict of arrays, every tensor
    on ``device`` but the generator state, which stays on the CPU (the
    rollout generator's device)."""
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def flow(d):
        return FlowState(**{k: dev(v) for k, v in d.items()})

    env_state = None
    st = tree.get("env_state")
    if isinstance(st, dict):
        env_state = EnvState(
            flow=flow(st["flow"]), jet_vel=dev(st["jet_vel"]),
            t=dev(st["t"]),
            scn=ScenarioParams(**{k: dev(v) for k, v in st["scn"].items()}),
            reset_flow=flow(st["reset_flow"]) if "reset_flow" in st
            else None)
    elif st is not None:
        env_state = dev(st)
    return TrainState(
        params={k: dev(v) for k, v in tree["params"].items()},
        opt_state={k: [dev(a) for a in v]
                   for k, v in tree["opt_state"].items()},
        rng=torch.as_tensor(np.asarray(tree["rng"], np.uint8)),
        step=int(tree["step"]), episode=int(tree["episode"]),
        env_state=env_state,
        obs=dev(tree["obs"]) if "obs" in tree else None,
        history={k: np.asarray(v)
                 for k, v in tree.get("history", {}).items()})


def state_metadata(ts: TrainState,
                   extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Manifest metadata for one TrainState save."""
    meta = {"schema": TRAIN_STATE_SCHEMA, "episode": int(ts.episode)}
    meta.update(extra or {})
    return meta


def save_train_state(path: str, ts: TrainState, *,
                     metadata: Optional[Dict[str, Any]] = None,
                     compress: bool = True) -> int:
    """One-shot synchronous save (``train()`` uses ``AsyncCheckpointer``
    with ``to_tree``/``state_metadata`` instead)."""
    return ckpt.save(path, to_tree(ts), step=int(ts.episode),
                     compress=compress, metadata=state_metadata(ts, metadata))


def load_train_state(path: str, device="cuda"
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    """-> (TrainState on ``device``, manifest metadata)."""
    arrays, manifest = ckpt.restore(path)
    meta = manifest.get("metadata", {})
    if meta.get("schema") != TRAIN_STATE_SCHEMA:
        raise ckpt.CheckpointError(
            f"{path} is not a train-state checkpoint (metadata schema "
            f"{meta.get('schema')!r} != {TRAIN_STATE_SCHEMA!r}); it may be "
            f"a raw tree checkpoint: load it with ckpt.restore instead")
    return from_tree(_nest(arrays), device), meta


def resolve_resume(resume: Any, ckpt_dir: Optional[str] = None
                   ) -> Optional[str]:
    """Resolve a resume spec to a checkpoint file path (None = fresh run).

    ``True`` / ``"latest"``: the latest valid checkpoint under ``ckpt_dir``
    (error when there is none, or no ``ckpt_dir``).  ``"auto"``: the same,
    but a fresh run when the directory holds no checkpoint yet (the
    preemptible-job idiom).  Anything else: an explicit ``.ckpt`` path or a
    checkpoint directory."""
    if not resume:
        return None
    if resume is True or resume in ("latest", "auto"):
        if not ckpt_dir:
            raise ValueError(f"resume={resume!r} needs ckpt_dir to be set "
                             f"(or pass an explicit checkpoint path)")
        path = ckpt.latest_checkpoint(ckpt_dir)
        if path is None:
            if resume == "auto":
                return None               # nothing to resume yet: fresh run
            raise ckpt.CheckpointError(
                f"resume={resume!r} but no valid checkpoint under "
                f"{ckpt_dir!r}")
        return path
    p = Path(str(resume))
    if p.is_dir():
        path = ckpt.latest_checkpoint(str(p))
        if path is None:
            raise ckpt.CheckpointError(
                f"no valid checkpoint under directory {p}")
        return path
    if not p.exists():
        raise ckpt.CheckpointError(f"resume checkpoint not found: {p}")
    return str(p)


# ---------------------------------------------------------------------------
# run fingerprint + compatibility
# ---------------------------------------------------------------------------

def code_fingerprint() -> Dict[str, Any]:
    """Which code wrote the state: informational, beside the strict
    top-level ``framework`` field of :func:`run_metadata`."""
    return {"framework": "torch", "torch": torch.__version__,
            "state_schema": TRAIN_STATE_SCHEMA}


def run_metadata(*, n_envs: int, obs_dim: int, seed: int, grid,
                 horizon: int, steps_per_action: int,
                 scenarios: Optional[Tuple[str, ...]],
                 plan: Optional[Dict[str, Any]] = None,
                 policy: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The run fingerprint stored beside every checkpoint: everything that
    must match for a bitwise resume (``RESUME_STRICT_FIELDS``) plus the
    seed, the plan actually executed and the code fingerprint
    (informational: a resume may change the plan).  ``plan`` is
    {"n_envs", "n_ranks", "backend", "n_processes"} of a resolved plan
    (None: no plan, the single-host default).  ``policy`` is the
    architecture fingerprint ({"policy", "obs_dim", "act_dim"}): an MLP's
    params cannot restore into an attention run."""
    return {
        "n_envs": int(n_envs),
        "obs_dim": int(obs_dim),
        "seed": int(seed),
        "grid": {"res": int(grid.res), "nx": int(grid.nx),
                 "ny": int(grid.ny), "dt": float(grid.dt)},
        "horizon": int(horizon),
        "steps_per_action": int(steps_per_action),
        "scenarios": list(scenarios) if scenarios else None,
        "plan": plan or {"n_envs": int(n_envs), "n_ranks": 1,
                         "backend": "single-host"},
        "policy": policy or {"policy": "mlp"},
        "framework": "torch",
        "code": code_fingerprint(),
    }


def check_resume_compatible(meta: Dict[str, Any], current: Dict[str, Any]
                            ) -> List[str]:
    """Raise ``CheckpointError`` listing every strict-field mismatch between
    a checkpoint's metadata and the current run's fingerprint; returns
    human-readable notes for allowed differences (the plan, the seed)."""
    errs = [f"{f}: checkpoint={meta.get(f)!r} current={current.get(f)!r}"
            for f in RESUME_STRICT_FIELDS if meta.get(f) != current.get(f)]
    if errs:
        raise ckpt.CheckpointError(
            "checkpoint is incompatible with the current TrainConfig "
            "(these change the physics, the batch layout, the policy or "
            "the framework, so resuming would not continue the same "
            "run):\n  " + "\n  ".join(errs))
    notes = []
    if meta.get("plan") != current.get("plan"):
        notes.append(f"cross-plan resume: checkpoint ran {meta.get('plan')}, "
                     f"resuming onto {current.get('plan')} (the env batch "
                     f"restored onto this run's device)")
    if meta.get("seed") != current.get("seed"):
        notes.append(f"seed differs (checkpoint {meta.get('seed')}, config "
                     f"{current.get('seed')}): ignored, the restored "
                     f"generator state is authoritative")
    return notes
