"""Modality frontend stubs and their learned projector.

Port of ``repro.models.frontend``.  [audio] seamless-m4t: the
mel-spectrogram and conv feature extractor are stubbed; the model consumes
precomputed frame embeddings (B, T_frames, frontend_dim).  [vision]
qwen2-vl: the ViT encoder is stubbed; the model consumes precomputed patch
embeddings (B, n_patches, frontend_dim).  The linear projector
(frontend_dim -> d_model) is real and trained; only the upstream encoder
is a stub.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, dtype_of

AUDIO_FRONTEND_DIM = 1024      # w2v-BERT 2.0 frame features
VISION_FRONTEND_DIM = 1280     # Qwen2-VL ViT width
AUDIO_DOWNSAMPLE = 8           # frames per decoder token budget (T_enc = S // 8)
VISION_PATCHES = 1024          # stub patch count (dynamic-resolution placeholder)


def frontend_dim(cfg: ModelConfig) -> int:
    return {"audio": AUDIO_FRONTEND_DIM,
            "vision": VISION_FRONTEND_DIM}[cfg.frontend]


def init_frontend(cfg: ModelConfig, gen: torch.Generator):
    """``{"projector": (frontend_dim, d_model)}``, or ``{}`` without a
    frontend."""
    if not cfg.frontend:
        return {}
    dt = dtype_of(cfg.param_dtype)
    return {"projector": dense_init(gen, (frontend_dim(cfg), cfg.d_model),
                                    dt)}


def project(cfg: ModelConfig, p, embeds):
    """The embeddings (B, T, frontend_dim) in the compute dtype times the
    projector -> (B, T, d_model)."""
    cd = dtype_of(cfg.compute_dtype)
    return embeds.to(cd) @ p["projector"].to(cd)


def num_frontend_tokens(cfg: ModelConfig, seq_len: int) -> int:
    """Frames an audio prompt of ``seq_len`` tokens carries (S // 8, at
    least 8), or patches a vision prompt carries (S // 4 within [8,
    1024]); 0 without a frontend."""
    if cfg.frontend == "audio":
        return max(8, seq_len // AUDIO_DOWNSAMPLE)
    if cfg.frontend == "vision":
        return min(VISION_PATCHES, max(8, seq_len // 4))
    return 0
