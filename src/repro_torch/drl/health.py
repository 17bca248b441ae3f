"""Training-health watchdog: anomaly detection over the learner's episode
metrics, driving checkpoint rollback in ``train()``.

Port of ``repro.drl.health``.  The divergence sentinel (``cfd/env.py``)
and the non-finite-gradient skip (``drl/ppo.py``) handle point failures
inside an episode; the watchdog covers the slower failure mode they cannot:
a run whose losses drift into garbage over several episodes while every
single quantity stays finite.  It watches a rolling window of episode
metrics on the host and reports an anomalous episode; ``train()`` raises
:class:`DivergenceError`, rolls back to the last healthy checkpoint and
replays (bounded retries, then an actionable error).

``ppo_update`` returns its metrics as 0-d tensors; ``train()`` reads them
to the host in one transfer per episode and hands floats to
:meth:`Watchdog.observe`.

Thresholds are deliberately loose: a loss must exceed the rolling median
by ``spike_factor`` (default 100x) before it fires.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.testing import faults

# episode metrics the watchdog screens for non-finiteness / spikes
WATCHED = ("policy_loss", "value_loss", "grad_norm")


class DivergenceError(RuntimeError):
    """Training metrics diverged; carries the offending episode + reason."""

    def __init__(self, episode: int, reason: str):
        super().__init__(
            f"training watchdog tripped at episode {episode}: {reason}")
        self.episode = episode
        self.reason = reason


@dataclass(frozen=True)
class WatchdogConfig:
    window: int = 8              # rolling episodes per watched metric
    spike_factor: float = 100.0  # |metric| > factor * rolling median -> trip
    kl_limit: float = 10.0       # |approx_kl| above this is a broken policy
    max_rollbacks: int = 3       # bounded retries before giving up


class Watchdog:
    """Screens one episode's update metrics; remembers a rolling window."""

    def __init__(self, cfg: WatchdogConfig = WatchdogConfig()):
        self.cfg = cfg
        self._hist: Dict[str, deque] = {
            k: deque(maxlen=cfg.window) for k in WATCHED}

    def observe(self, metrics: Optional[Dict[str, float]], *,
                episode: int) -> Optional[str]:
        """Returns a trip reason (str) or None when the episode is healthy.

        Healthy metrics are folded into the rolling window; anomalous ones
        are not (a single bad episode must not poison the baseline the next
        comparison uses)."""
        if faults.consume("watchdog", episode=int(episode)):
            return "injected watchdog fault"
        if not metrics:
            return None
        vals = {k: float(metrics[k]) for k in (*WATCHED, "approx_kl")
                if k in metrics}
        for k, v in vals.items():
            if not np.isfinite(v):
                return f"non-finite {k} ({v})"
        kl = vals.get("approx_kl")
        if kl is not None and abs(kl) > self.cfg.kl_limit:
            return (f"approx_kl {kl:.3g} exceeds limit "
                    f"{self.cfg.kl_limit:.3g}")
        for k in WATCHED:
            if k not in vals:
                continue
            hist = self._hist[k]
            if len(hist) == hist.maxlen:   # only with a full baseline window
                med = float(np.median(np.abs(hist)))
                if abs(vals[k]) > self.cfg.spike_factor * max(med, 1e-6):
                    return (f"{k} {vals[k]:.3g} spiked past "
                            f"{self.cfg.spike_factor:.0f}x the rolling "
                            f"median {med:.3g}")
        for k in WATCHED:
            if k in vals:
                self._hist[k].append(vals[k])
        return None


def resolve_watchdog(spec) -> Optional[Watchdog]:
    """``TrainConfig.watchdog`` -> Watchdog | None: True for the default
    thresholds, a WatchdogConfig for custom ones, False/None for off."""
    if not spec:
        return None
    return Watchdog(spec if isinstance(spec, WatchdogConfig)
                    else WatchdogConfig())
