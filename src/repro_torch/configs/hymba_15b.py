"""Hymba-1.5B — hybrid parallel attention + mamba heads. [arXiv:2411.13676]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,          # GQA kv=5
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    rope_theta=10_000.0,
    activation="swiglu",
    attention_kind="hybrid",     # parallel attn + SSM heads in every block
    sliding_window=1024,         # Hymba uses SWA in most layers -> long_500k native
    ssm=SSMConfig(kind="mamba", state_size=16, expand=2),
    train_microbatches=4,
))
