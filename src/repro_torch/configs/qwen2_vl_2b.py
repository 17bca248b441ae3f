"""Qwen2-VL-2B backbone (M-RoPE, dynamic resolution). [arXiv:2409.12191]

The vision frontend (ViT + projector) is a stub: the model consumes
precomputed patch embeddings (``models/frontend.py``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,          # GQA kv=2
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),   # temporal/height/width sections of head_dim/2
    rope_theta=1_000_000.0,
    activation="swiglu",
    frontend="vision",
    train_microbatches=4,    # 152k vocab
))
