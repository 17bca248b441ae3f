"""SeamlessM4T-large v2 transformer backbone (enc-dec, audio). [arXiv:2308.11596]

The modality frontend (mel-spectrogram + conv feature extractor) is a stub:
the model consumes precomputed frame embeddings (``models/frontend.py``).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    num_layers=24,           # text decoder layers
    encoder_layers=24,       # speech encoder layers (consumes stub frame embeddings)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,         # GQA kv=16 (== MHA)
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_kind="none",        # learned/sinusoidal positions in M4T; we use sinusoidal
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    train_microbatches=4,    # 256k vocab
))
