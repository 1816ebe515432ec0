"""Unified model configuration covering all assigned architecture families.

A verbatim copy of ``repro.models.config``: pure dataclasses, so a
configuration means the same in both packages. The torch package runs
every family.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 2
    top_k: int = 6
    d_ff_expert: int = 1408
    first_k_dense: int = 1          # deepseek: first layer(s) use dense FFN
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 64                 # SSD chunk length


@dataclass(frozen=True)
class HybridConfig:
    """zamba2: shared attention block applied every `period` SSM layers."""
    period: int = 6
    shared_d_ff: int = 8192
    shared_n_heads: int = 32
    shared_n_kv_heads: int = 32


@dataclass(frozen=True)
class EncDecConfig:
    """whisper: encoder over stubbed frame embeddings."""
    n_enc_layers: int = 12
    n_frames: int = 1500            # precomputed conv-frontend output length


@dataclass(frozen=True)
class VLMConfig:
    """internvl: stubbed ViT patch embeddings + projector."""
    n_patches: int = 256
    vit_dim: int = 3200


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # pad the embedding/unembedding tables to a multiple of this so odd
    # vocabs (51865, 50280) stay TP-shardable; padded logits are masked
    # to -inf everywhere they surface (§Perf backlog #3)
    vocab_pad_multiple: int = 1
    # attention pattern
    sliding_window: int | None = None
    global_every: int | None = None  # gemma3: every Nth layer is global
    global_rope_theta: float = 1e6
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # numerics
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    use_flash_kernel: bool = False  # Pallas attention (TPU deploy flag)
    flash_schedule: str = "morton"
    # residual-stream sharding for (B, S, D) activations; set by the
    # launcher per mesh, e.g. (("pod","data"), "model", None) = batch +
    # sequence sharding (Megatron-SP). None -> let GSPMD propagate.
    act_spec: tuple | None = None
    # decode-attention score sharding for (B, H, 1, Sk); set by the
    # launcher to match the sequence-sharded KV cache, e.g.
    # (batch_axes, None, None, "model") — pins GSPMD to distributed
    # partial-softmax attention instead of all-gathering the cache.
    score_spec: tuple | None = None
    # expert-parallel mesh axis for MoE dispatch buffers; pins the
    # (B, E, C, ·) buffers to P(batch, ep_axis, …) so expert GEMMs are
    # EP-sharded instead of replicated (§Perf log).
    ep_axis: str | None = None

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_is_global(self, layer_idx: int) -> bool:
        """gemma3 local:global pattern; non-windowed models are all-global."""
        if self.sliding_window is None:
            return True
        if self.global_every is None:
            return False
        return (layer_idx + 1) % self.global_every == 0
