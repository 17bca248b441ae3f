"""RWKV-6 "Finch" 3B — attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=2560,
    num_heads=40,            # 2560 / 64-dim wkv heads
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention_kind="none",
    rope_kind="none",
    norm="layernorm",        # RWKV uses LayerNorm
    activation="rwkv_ffn",   # relu^2 channel-mix
    ssm=SSMConfig(kind="rwkv6", head_dim=64),
    train_microbatches=2,
))
