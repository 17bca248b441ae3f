"""Mistral-Large-Instruct-2407 (123B dense). [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    activation="swiglu",
    optimizer="adafactor",   # 123B: HBM-fit policy (DESIGN.md §8)
    train_microbatches=4,
    kv_cache_dtype="float8_e4m3fn",  # serving HBM fit for 32k x big-batch decode
))
