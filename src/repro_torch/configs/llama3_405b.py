"""Llama-3.1 405B dense (GQA, 128k vocab). [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500_000.0,
    activation="swiglu",
    optimizer="adafactor",   # 405B: HBM-fit policy (DESIGN.md §8)
    train_microbatches=4,    # §Perf: FSDP regather traffic ~ mb count (X 421->217s)
    kv_cache_dtype="float8_e4m3fn",  # serving HBM fit for 32k x big-batch decode
))
