"""Phi-3.5-MoE (42B total / 6.6B active, 16 experts top-2). [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=6400,               # expert FFN width
    vocab_size=32064,
    rope_theta=10_000.0,
    activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                  impl="shard_map"),   # the reference's expert-parallel
                                       # path; one card runs _moe_dispatch
    train_microbatches=4,
))
