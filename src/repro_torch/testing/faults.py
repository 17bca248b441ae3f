"""Deterministic fault injection for the self-healing training stack.

Port of ``repro.testing.faults``, with the same fault kinds and the same
``REPRO_FAULTS`` JSON.  Every recovery path of the trainer (per-env
quarantine, non-finite-gradient skip, watchdog rollback, checkpoint-crash
recovery) is driven through this module.  Faults are configured either
programmatically (:func:`configure`) or through the ``REPRO_FAULTS``
environment variable holding a JSON object, e.g.::

    REPRO_FAULTS='{"nan_env": {"env": 1, "step": 4}, "grad_nan": {"step": 6}}'

Supported fault kinds:

``nan_env``
    Poison the velocity field ``u`` of env ``env`` (its index along the
    batch's leading dim) with NaN at env-step ``step``, just before the
    solver interval.  ``step`` is the within-episode actuation counter
    (``EnvState.t``), which restarts at 0 every episode, so the fault fires
    once per episode it stays armed.
``grad_nan``
    Corrupt the gradients of the PPO minibatch whose update-step counter
    equals ``step``.  The counter is monotonic across the run (it indexes
    Adam's bias correction), so this fires exactly once.
``watchdog``
    Force the training watchdog to trip at episode ``episode`` (consumed
    once).
``sink_oserror``
    Make the next ``times`` (default 1) sink writes raise ``OSError``
    (decremented per raise).
``ckpt_crash``
    Crash (``OSError``) the checkpoint write for step ``step`` just before
    its atomic rename, leaving a stale ``*.tmp`` behind: the torn-write
    shape ``latest_checkpoint`` must recover from.  Consumed once.

The reference reads ``nan_env`` and ``grad_nan`` at trace time, before its
jitted program is built, and bakes them into the trace.  The port has no
trace: ``env_step`` and ``ppo_update`` read them at every call, so they
may be (re)configured at any point, like the host-side kinds.  The firing
rule is the same: once per episode for ``nan_env``, once per run for
``grad_nan``.  :func:`reset` clears everything.

This module is stdlib-only: importing it pulls in nothing of torch.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

ENV_FAULTS = "REPRO_FAULTS"

_spec: Dict[str, Dict[str, Any]] = {}
_loaded_env = False


def configure(spec: Optional[Dict[str, Dict[str, Any]]]) -> None:
    """Install a fault spec programmatically (replaces any active spec)."""
    global _spec, _loaded_env
    _spec = {k: dict(v) for k, v in (spec or {}).items()}
    _loaded_env = True   # explicit config wins over the environment


def reset() -> None:
    """Clear all faults and re-arm environment-variable loading."""
    global _spec, _loaded_env
    _spec = {}
    _loaded_env = False


def _load() -> Dict[str, Dict[str, Any]]:
    global _spec, _loaded_env
    if not _loaded_env:
        _loaded_env = True
        raw = os.environ.get(ENV_FAULTS)
        if raw:
            try:
                parsed = json.loads(raw)
            except ValueError as e:
                raise ValueError(
                    f"{ENV_FAULTS} is not valid JSON: {raw!r} ({e})") from e
            if not isinstance(parsed, dict):
                raise ValueError(
                    f"{ENV_FAULTS} must be a JSON object mapping fault kind "
                    f"to parameters, got: {raw!r}")
            _spec = {k: dict(v) for k, v in parsed.items()}
    return _spec


def active(kind: str) -> Optional[Dict[str, Any]]:
    """The parameters of ``kind`` if armed, else None (a non-consuming
    peek; ``env_step`` and ``ppo_update`` read theirs this way)."""
    return _load().get(kind)


def consume(kind: str, **match: Any) -> bool:
    """Check-and-consume for one-shot faults.

    Returns True when ``kind`` is armed and every keyword matches the spec
    (missing spec keys match anything); the fault is then disarmed.  A
    ``times`` counter in the spec allows multiple firings.
    """
    spec = _load().get(kind)
    if spec is None:
        return False
    for k, v in match.items():
        if k in spec and spec[k] != v:
            return False
    times = int(spec.get("times", 1)) - 1
    if times <= 0:
        _spec.pop(kind, None)
    else:
        spec["times"] = times
    return True


def maybe_fail_io(path: str) -> None:
    """Raise OSError if a ``sink_oserror`` fault is armed (consumes one)."""
    if consume("sink_oserror"):
        raise OSError(f"injected sink_oserror for {path}")


def maybe_crash_ckpt(step: int, path: str) -> None:
    """Raise OSError if a ``ckpt_crash`` fault matches this checkpoint step."""
    if consume("ckpt_crash", step=int(step)):
        raise OSError(f"injected ckpt_crash at step {step} for {path}")
