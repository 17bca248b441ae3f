"""Config schema of the language-model substrate.

The port's own copy of ``repro.configs.base`` (plain dataclasses, no
framework dependency): ``ModelConfig`` and its parts, ``reduced()`` (the CPU
smoke variant: 2 layers, d_model <= 256, <= 4 experts), the input shapes and
the registry.  Only the configs whose model path is ported register here:
``phi4-mini-3.8b`` and ``rwkv6-3b``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # Dense-FFN prefix (DeepSeek-V3 keeps the first 3 layers dense).
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # 'gspmd'  : gather/scatter dispatch, XLA chooses collectives (baseline)
    # 'shard_map': explicit all-to-all expert parallelism (optimized path)
    impl: str = "gspmd"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "rwkv6"          # 'rwkv6' | 'mamba'
    state_size: int = 16          # mamba ssm state; rwkv uses head_dim x head_dim
    head_dim: int = 64
    expand: int = 2               # mamba inner expansion
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    source: str                   # citation for the config numbers
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    attention_kind: str = "gqa"   # gqa | mla | none | hybrid
    rope_kind: str = "rope"       # rope | mrope | none
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0       # 0 -> full attention
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    activation: str = "swiglu"    # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (seamless): encoder_layers > 0 enables the encoder stack.
    encoder_layers: int = 0
    frontend: str = ""            # '' | 'audio' | 'vision'  (stub embeddings)
    mtp: bool = False             # DeepSeek multi-token prediction head
    optimizer: str = "adamw"      # adamw | adafactor  (HBM-fit policy, DESIGN.md §8)
    train_microbatches: int = 1   # gradient accumulation (activation HBM fit)
    kv_cache_dtype: str = ""      # '' = compute dtype; 'float8_e4m3fn' for
                                  # the big dense archs (serving HBM fit)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # remat policy for train_step: '' | 'full' | 'dots'
    remat: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table size: vocab padded to a multiple of 256 so the
        vocab axis shards on any mesh (Megatron-style).  Only seamless
        (256206) and hymba (32001) actually pad; logits over padded slots
        train toward -inf naturally (never the label)."""
        if self.vocab_size % 256 == 0:
            return self.vocab_size
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_decode(self) -> bool:
        return True  # no encoder-only archs in this assignment

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: 2 layers, d_model<=512, <=4 experts, small vocab."""
        d_model = min(self.d_model, 256)
        # keep head structure ratios but shrink
        num_heads = max(2, min(self.num_heads, 4))
        num_kv_heads = max(1, min(self.num_kv_heads, num_heads))
        head_dim = d_model // num_heads
        moe = None
        if self.moe is not None:
            moe = replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), d_ff_expert=128,
                num_shared_experts=min(1, self.moe.num_shared_experts),
                first_dense_layers=min(1, self.moe.first_dense_layers),
                capacity_factor=8.0)   # effectively dropless at smoke scale
        mla = None
        if self.mla is not None:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=head_dim, qk_rope_head_dim=16,
                            v_head_dim=head_dim)
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, state_size=min(8, self.ssm.state_size),
                          head_dim=min(32, self.ssm.head_dim))
            if self.ssm.kind == "rwkv6":
                # rwkv requires H * wkv_head_dim == d_model
                num_heads = d_model // ssm.head_dim
                num_kv_heads = num_heads
                head_dim = ssm.head_dim
        sections = ()
        if self.mrope_sections:
            h = head_dim // 2
            a = h // 3
            sections = (h - 2 * a, a, a)
        return replace(
            self, name=self.name + "-reduced", num_layers=2, d_model=d_model,
            num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
            d_ff=min(self.d_ff, 512), vocab_size=min(self.vocab_size, 512),
            moe=moe, mla=mla, ssm=ssm, encoder_layers=min(self.encoder_layers, 2),
            mrope_sections=sections, sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0, train_microbatches=1,
            kv_cache_dtype="",
            param_dtype="float32", compute_dtype="float32", remat="")


# ---------------------------------------------------------------------------
# Input shapes assigned to this paper (public pool).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # import side-effect registers each config module
    from repro_torch.configs import phi4_mini_38b, rwkv6_3b  # noqa: F401
