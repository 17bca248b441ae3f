"""Data pipeline: the synthetic LM token stream and a device-resident DRL
trajectory store.

Port of ``repro.data.pipeline``.  The LM stream is deterministic by step:
(seed, step) -> batch in host numpy, the reference's tokens bit for bit,
so every data-parallel worker can slice its own shard without
coordination.  The modality frontends are not ported (``ROADMAP.md`` §1
item 7), so a config with a ``frontend`` raises.  Placing a batch on a
mesh (the reference's ``shard_batch``) waits for the mesh slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # zipf-ish skew so loss curves look like text, not uniform noise
    zipf_alpha: float = 1.1


def synthetic_batch(cfg: LMDataConfig, step: int,
                    model_cfg: Optional[ModelConfig] = None) -> Dict:
    """Deterministic synthetic batch for a given step (host numpy)."""
    if model_cfg is not None and model_cfg.frontend:
        raise NotImplementedError(
            f"{model_cfg.name}: frontend {model_cfg.frontend!r} embeddings "
            f"are not ported yet (ROADMAP.md §1 item 7, the modality "
            f"frontends)")
    rng = np.random.default_rng((cfg.seed, step))
    ranks = rng.zipf(cfg.zipf_alpha,
                     size=(cfg.global_batch, cfg.seq_len + 1))
    tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def lm_iterator(cfg: LMDataConfig, model_cfg: Optional[ModelConfig] = None,
                start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, model_cfg)
        step += 1


# ---------------------------------------------------------------------------
# DRL trajectory store (device-resident, the 'optimized interface' data path)
# ---------------------------------------------------------------------------

def _cat(items):
    """Concatenate along dim 0 leaf by leaf: tensors, and namedtuples /
    tuples / dicts of them (None leaves stay None)."""
    first = items[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return torch.cat(items, dim=0)
    if isinstance(first, dict):
        return {k: _cat([x[k] for x in items]) for k in first}
    if isinstance(first, tuple):
        parts = [_cat(list(xs)) for xs in zip(*items)]
        return type(first)(*parts) if hasattr(first, "_fields") \
            else tuple(parts)
    raise TypeError(f"cannot concatenate {type(first).__name__} batches")


class TrajectoryStore:
    """Accumulates rollout batches on the device; never round-trips the
    host.  The I/O-optimized counterpart of ``core.interface.FileInterface``:
    the (s, a, r) stream stays in device memory and PPO consumes it in
    place."""

    def __init__(self, capacity_episodes: int = 8):
        self.capacity = capacity_episodes
        self._buf = []

    def add(self, batch):
        self._buf.append(batch)
        if len(self._buf) > self.capacity:
            self._buf.pop(0)

    def sample_all(self):
        if len(self._buf) == 1:
            return self._buf[0]
        return _cat(self._buf)

    def __len__(self):
        return len(self._buf)
