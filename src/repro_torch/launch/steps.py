"""The language model's serving steps: ``make_prefill_step`` and
``make_serve_step``.

Port of the serving half of ``repro.launch.steps``.  There is no mesh
argument yet: the port's activation sharding waits with ``ROADMAP.md`` §1
item 5.8, and the training steps with item 5.7.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.attention import resolve_backend


def make_prefill_step(cfg: ModelConfig,
                      backend: Optional[str] = None) -> Callable:
    """``prefill_step(params, tokens) -> (logits (B, V), cache)``.  Prefill
    always runs the reference mixers, as the reference's does (the flash
    kernel serves training's causal forward); ``backend`` is validated all
    the same, so an unknown selection fails here."""
    resolve_backend(backend)

    def prefill_step(params, tokens):
        return M.prefill(cfg, params, tokens)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """``serve_step(params, cache, token, pos) -> (logits (B, V), cache)``:
    one ``decode_step``, the cache updated in place."""
    def serve_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos)
    return serve_step
