"""DeepSeek-V3 671B — MLA, 1 shared + 256 routed experts top-8, MTP. [arXiv:2412.19437]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,        # MLA: all heads share the compressed latent
    head_dim=128,
    d_ff=18432,              # dense-FFN width for the first_dense_layers prefix
    vocab_size=129280,
    rope_theta=10_000.0,
    activation="swiglu",
    attention_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, first_dense_layers=3,
                  impl="shard_map"),   # the reference's expert-parallel
                                       # path; one card runs _moe_dispatch
    mtp=True,
    optimizer="adafactor",   # 671B: the reference's memory-fit policy
    train_microbatches=4,
))
