"""Architecture configs for the port: ``ArchConfig``, ``reduced()`` and
the models the port knows: the paper's Whisper model, xlstm-350m, the
dense and MoE decoder-only families, and zamba2-7b (data only: its
model is not ported yet).

A copy of the JAX package's ``repro.configs`` (the port imports nothing
from it), cut to the models the port knows.
``reduced()`` produces the CPU-test shrink of a config with the same
rule as the reference, so both packages build identically shaped
parameters from one config name.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads

    # attention features
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global: bool = False
    local_window: int = 4096
    rope_theta: float = 10000.0
    attn_bias: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0

    # xLSTM
    xlstm: bool = False
    proj_factor: float = 2.0

    # encoder-decoder (whisper)
    enc_dec: bool = False
    enc_layers: int = 0

    # VLM
    vlm: bool = False
    n_img_tokens: int = 0

    # general
    norm_eps: float = 1e-6
    act: str = "silu"            # silu | gelu
    tie_embeddings: bool = False
    remat: bool = True
    dtype: str = "bf16"          # activation/compute dtype
    source: str = ""             # provenance note

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def scan_unit(self) -> int:
        """Layers per scanned segment (heterogeneous stacks scan groups)."""
        if self.family == "hybrid" and self.attn_every:
            return self.attn_every
        if self.xlstm or self.local_global:
            return 2
        return 1


WHISPER_TINY_EN = ArchConfig(
    name="whisper-tiny.en", family="audio",
    n_layers=4, enc_layers=4, enc_dec=True,
    d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865,
    act="gelu", tie_embeddings=True,
    source="whisper.cpp / arXiv:2212.04356",
)

# d_ff=0: the blocks carry their own 2x up/down projections (proj_factor);
# 24 blocks = 12 (mLSTM, sLSTM) pairs
XLSTM_350M = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, xlstm=True, proj_factor=2.0,
    source="arXiv:2405.04517 (unverified tier)",
)

QWEN3_4B = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=9728, vocab=151936,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (hf tier)",
)

GEMMA2_2B = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab=256000,
    local_global=True, local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    act="gelu", tie_embeddings=True,
    source="arXiv:2408.00118 (hf tier)",
)

MIXTRAL_8X7B = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, n_experts=8, top_k=2,
    sliding_window=4096, rope_theta=1e6,
    source="arXiv:2401.04088 (hf tier)",
)

QWEN3_MOE_30B_A3B = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936, n_experts=128, top_k=8,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B (hf tier)",
)

DEEPSEEK_7B = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400,
    source="arXiv:2401.02954 (hf tier)",
)

CODEQWEN15_7B = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, attn_bias=True, rope_theta=1e6,
    source="hf:Qwen/CodeQwen1.5-7B (hf tier)",
)

LLAVA_NEXT_34B = ArchConfig(
    name="llava-next-34b", family="vlm", vlm=True, n_img_tokens=2880,
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_head=128,
    d_ff=20480, vocab=64000, rope_theta=5e6,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified tier)",
)

# data only: the mamba blocks and the hybrid pattern are not ported yet
ZAMBA2_7B = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_conv=4, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242 (unverified tier)",
)

_REGISTRY = {"whisper_tiny_en": WHISPER_TINY_EN, "xlstm_350m": XLSTM_350M,
             "qwen3_4b": QWEN3_4B, "gemma2_2b": GEMMA2_2B,
             "mixtral_8x7b": MIXTRAL_8X7B,
             "qwen3_moe_30b_a3b": QWEN3_MOE_30B_A3B,
             "deepseek_7b": DEEPSEEK_7B, "codeqwen15_7b": CODEQWEN15_7B,
             "llava_next_34b": LLAVA_NEXT_34B, "zamba2_7b": ZAMBA2_7B}


def list_archs() -> list[str]:
    return [n.replace("_", "-") for n in _REGISTRY]


def get_config(name: str) -> ArchConfig:
    key = name.replace("-", "_").replace(".", "")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[key]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test shrink: same family and block pattern, tiny dims."""
    unit = cfg.scan_unit
    kv = min(cfg.n_kv_heads, 2)
    heads = max(4, kv * max(1, min(2, cfg.n_heads // max(cfg.n_kv_heads, 1))))
    heads = (heads // kv) * kv or kv
    return dataclasses.replace(
        cfg,
        n_layers=2 * unit,
        enc_layers=2 if cfg.enc_dec else 0,
        d_model=128,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        sliding_window=64 if cfg.sliding_window else None,
        local_window=32 if cfg.local_global else cfg.local_window,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        n_img_tokens=16 if cfg.vlm else 0,
        remat=False,
    )
