"""Data pipeline: the synthetic LM token stream and a device-resident DRL
trajectory store.

Port of ``repro.data.pipeline``.  The LM stream is deterministic by step:
(seed, step) -> batch in host numpy, the reference's tokens bit for bit,
so every data-parallel worker can slice its own shard without
coordination.  A config with a modality frontend also gets its stub
embeddings, ``frontend_embeds`` (B, T, frontend_dim) float32, drawn from
the same generator after the tokens, the reference's bit for bit.
``shard_batch`` places a host batch on a mesh's device
(``launch/mesh.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontend as fe_mod


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
    rng = np.random.default_rng((cfg.seed, step))
    ranks = rng.zipf(cfg.zipf_alpha,
                     size=(cfg.global_batch, cfg.seq_len + 1))
    tokens = np.minimum(ranks, cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if model_cfg is not None and model_cfg.frontend:
        t = fe_mod.num_frontend_tokens(model_cfg, cfg.seq_len)
        d = fe_mod.frontend_dim(model_cfg)
        batch["frontend_embeds"] = rng.standard_normal(
            (cfg.global_batch, t, d)).astype(np.float32)
    return batch


def lm_iterator(cfg: LMDataConfig, model_cfg: Optional[ModelConfig] = None,
                start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, model_cfg)
        step += 1


def shard_batch(batch: Dict, sharding_tree) -> Dict:
    """Place a host batch onto the mesh: every array of ``batch`` as a
    tensor on the device ``sharding_tree`` names for it, a ``Mesh`` (this
    process's device of it), a device, or a dict of those by key."""
    from repro_torch.launch.mesh import Mesh

    def target(where):
        return where.local_device if isinstance(where, Mesh) \
            else torch.device(where)

    return {k: torch.as_tensor(np.asarray(x)).to(target(
        sharding_tree[k] if isinstance(sharding_tree, dict)
        else sharding_tree)) for k, x in batch.items()}


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
