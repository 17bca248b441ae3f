"""Decoder-only language model: init, ``forward_train``, ``lm_loss``.

Port of ``repro.models.model`` for ``attention_kind`` ``"gqa"`` (phi4-mini)
and ``"none"`` (RWKV-6).  Parameters are a plain dict shaped like the
reference's tree: ``{"embed", "blocks", "final_norm", "lm_head"}`` with
every leaf of ``blocks`` stacked on a leading layer axis; the reference's
``lax.scan`` over layers is a Python loop over that axis.  The reference's
``act_sharding.constrain`` calls place activations on a device mesh and do
nothing without one; the port runs on one card, so they are left out.
The remat policy is a training-memory choice of the reference's backward
pass and has no counterpart here.

``backend="pallas"`` runs each layer's sequence mixer through a
hand-written kernel: flash attention (``kernels/flash_attention``) for
``"gqa"``, WKV6 (``kernels/rwkv6``) for ``"none"``; one launch per layer
on CUDA tensors.  ``"reference"`` runs the plain PyTorch mixers.

Not ported yet: MoE, MLA, hybrid, the encoder-decoder, the frontends, MTP,
``prefill`` and ``decode_step``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dtype_of,
                                       embed_init, init_mlp, init_norm)

Params = Dict[str, Any]

ATTENTION_KINDS = ("gqa", "none")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config that needs a part of the
    reference's model that is not ported."""
    missing = []
    if cfg.attention_kind not in ATTENTION_KINDS:
        missing.append(f"attention_kind {cfg.attention_kind!r}")
    if cfg.attention_kind == "gqa" and cfg.rope_kind != "rope":
        missing.append(f"rope_kind {cfg.rope_kind!r}")
    for name, present in (("moe", cfg.moe is not None),
                          ("mla", cfg.mla is not None),
                          ("encoder-decoder", cfg.is_encdec),
                          ("frontend", bool(cfg.frontend)),
                          ("mtp", cfg.mtp)):
        if present:
            missing.append(name)
    if cfg.attention_kind == "none" and (cfg.ssm is None
                                         or cfg.ssm.kind != "rwkv6"):
        missing.append("an ssm other than rwkv6")
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported: "
                                  f"{', '.join(missing)}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_blocks(cfg: ModelConfig, gen: torch.Generator, n: int) -> Params:
    lead = (n,)
    p: Params = {"ln1": init_norm(cfg, lead + (cfg.d_model,), gen.device),
                 "ln2": init_norm(cfg, lead + (cfg.d_model,), gen.device)}
    if cfg.attention_kind == "none":
        p["tmix"] = ssm_mod.init_rwkv_tmix(cfg, gen, lead)
        p["cmix"] = ssm_mod.init_rwkv_cmix(cfg, gen, lead)
    else:
        p["attn"] = attn_mod.init_attention(cfg, gen, lead)
        p["ffn"] = init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, lead)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random parameters with the reference's distributions, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    p: Params = {"embed": embed_init(gen, (cfg.vocab_padded, cfg.d_model),
                                     dt)}
    p["blocks"] = _init_blocks(cfg, gen, cfg.num_layers)
    p["final_norm"] = init_norm(cfg, (cfg.d_model,), device)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_padded), dt)
    return p


def layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked block tree."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _mixer(cfg: ModelConfig, bp, h, positions, *, backend="reference"):
    """The causal self-attention of one block, on its normed input."""
    return attn_mod.apply_attention(cfg, bp["attn"],
                                    apply_norm(cfg, bp["ln1"], h), positions,
                                    backend=backend)


def _ffn(cfg: ModelConfig, bp, h):
    return apply_mlp(cfg, bp["ffn"], apply_norm(cfg, bp["ln2"], h))


def _block_body(cfg: ModelConfig, h, bp, *, positions, backend="reference"):
    """One residual block."""
    if cfg.attention_kind == "none":
        # rwkv: time mix + channel mix, zero shift states per sequence
        B, S, D = h.shape
        N = cfg.ssm.head_dim
        hn = apply_norm(cfg, bp["ln1"], h)
        state0 = torch.zeros((B, cfg.num_heads, N, N), dtype=torch.float32,
                             device=h.device)
        mix, _, _ = ssm_mod.apply_rwkv_tmix(
            cfg, bp["tmix"], hn, hn.new_zeros((B, D)), state0,
            backend=backend)
        h = h + mix
        hn = apply_norm(cfg, bp["ln2"], h)
        cm, _ = ssm_mod.apply_rwkv_cmix(cfg, bp["cmix"], hn,
                                        hn.new_zeros((B, D)))
        return h + cm
    h = h + _mixer(cfg, bp, h, positions, backend=backend)
    return h + _ffn(cfg, bp, h)


def _scan_blocks(cfg: ModelConfig, blocks, h, *, positions,
                 backend="reference"):
    """The layers in order (the reference's scan over the stacked axis)."""
    for i in range(blocks["ln1"]["scale"].shape[0]):
        h = _block_body(cfg, h, layer(blocks, i), positions=positions,
                        backend=backend)
    return h


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params, tokens):
    """The embedding rows of ``tokens`` in the compute dtype."""
    return params["embed"][tokens].to(dtype_of(cfg.compute_dtype))


def _positions(cfg: ModelConfig, tokens):
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def _unembed(cfg: ModelConfig, params, h):
    cd = dtype_of(cfg.compute_dtype)
    h = apply_norm(cfg, params["final_norm"], h)
    head = (params["embed"].to(cd).T if cfg.tie_embeddings
            else params["lm_head"].to(cd))
    return (h.to(cd) @ head).float()


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(cfg: ModelConfig, params: Params, tokens, *,
                  backend: Optional[str] = None):
    """tokens (B, S) int -> (logits (B, S, V) float32, aux loss 0.0)."""
    check_supported(cfg)
    backend = attn_mod.resolve_backend(backend)
    h = _embed(cfg, params, tokens)
    h = _scan_blocks(cfg, params["blocks"], h,
                     positions=_positions(cfg, tokens), backend=backend)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _unembed(cfg, params, h), aux


def _token_nll(cfg: ModelConfig, logits, labels):
    """Cross entropy per token, logsumexp minus the label's logit (the
    reference's one-hot contraction picks the same value)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    return lse - gold


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any], *,
            backend: Optional[str] = None):
    """batch: {"tokens": (B, S) int, "labels": (B, S) int[, "mask"]} ->
    (loss + aux, {"loss", "aux"})."""
    logits, aux = forward_train(cfg, params, batch["tokens"],
                                backend=backend)
    nll = _token_nll(cfg, logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        loss = nll.mean()
    return loss + aux, {"loss": loss, "aux": aux}
