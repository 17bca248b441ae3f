"""Qwen1.5-32B (dense, QKV bias, full MHA kv=40). [hf:Qwen/Qwen1.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,         # GQA kv=40 (== MHA)
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,           # Qwen1.5 uses QKV bias
    rope_theta=1_000_000.0,
    activation="swiglu",
    train_microbatches=2,
    kv_cache_dtype="float8_e4m3fn",  # serving HBM fit for 32k x big-batch decode
))
