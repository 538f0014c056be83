"""Model/config dataclasses (framework-free copy of the JAX package's)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one instance per assigned arch)."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"        # swiglu | gelu
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (zamba2-style shared attention blocks) ---
    attn_every: int = 0             # apply shared attn block every k layers (0=off)
    # --- modality frontend stubs ---
    frontend: str = "none"          # none | patch (vlm) | frame (audio)
    num_patches: int = 1024         # vlm: precomputed patch embeddings per sample
    num_codebooks: int = 1          # audio: EnCodec codebooks
    # --- execution variant (Xar-Trek target implementations) ---
    attn_impl: str = "ref"          # ref (HOST path) | flash (ACCEL kernel)
    sharding_recipe: str = "tp"     # tp (weights over model axis) | dp
                                    # (pure data parallel: batch over ALL
                                    # axes, weights replicated — right for
                                    # small models; the AUX target recipe)
    # --- numerics / memory ---
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "dots"             # nothing | dots | full

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid archs)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Analytic parameter count (unpadded), for MODEL_FLOPS."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        n = V * d  # embedding
        if not self.tie_embeddings:
            n += d * V * max(self.num_codebooks, 1)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            per_layer += d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
            per_layer += self.num_heads * hd * d
            if self.mlp_type == "swiglu":
                ffn = 3 * d * self.d_ff
            else:
                ffn = 2 * d * self.d_ff
            if self.family == "moe":
                per_layer += d * self.num_experts + self.num_experts * ffn
            else:
                per_layer += ffn
            per_layer += 2 * d
            n += L * per_layer
        elif self.family in ("ssm", "hybrid"):
            di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
            proj = 2 * di + 2 * ns + nh
            per_layer = d * proj + (di + 2 * ns) * self.conv_kernel
            per_layer += 3 * nh + di + di * d + 2 * d
            n += L * per_layer
            if self.family == "hybrid":
                # one shared attention+mlp block
                n += (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                      + self.num_heads * hd * d + 3 * d * self.d_ff + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.num_layers
        ffn = 3 * d * self.d_ff if self.mlp_type == "swiglu" else 2 * d * self.d_ff
        inactive = L * (self.num_experts - self.top_k) * ffn
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Step-level knobs (shape-dependent; perf loop rewrites these)."""

    microbatches: int = 1           # grad-accum splits of the global batch
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    zero1: bool = True              # shard optimizer moments over data axis
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
