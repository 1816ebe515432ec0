"""internvl2-76b [vlm]: InternViT (stub) + LLaMA-70B-class LM
(arXiv:2404.16821).

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, head_dim=128.
Frontend stubbed per assignment: ``input_specs`` provides 256 precomputed
ViT patch embeddings (vit_dim=3200, InternViT-6B width) which a learned
projector maps to d_model and prepends to the token sequence.
The same configurations as ``repro.configs.internvl2_76b``.
"""

from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    vlm=VLMConfig(n_patches=256, vit_dim=3200),
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke", family="vlm",
    n_layers=3, d_model=96, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=12,
    vlm=VLMConfig(n_patches=8, vit_dim=48),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width. The 80 layers' f32
# weights (282.3 GB: 70.58 B parameters) do not fit one 80 GB card, so it
# runs 8 layers (35.9 GB with the embedding, unembedding and projector);
# the prefill_32k cell cut to B=4 sequences of S=2048 (256 patches and
# 1792 text tokens) and a decode of 4 requests of 16-token prompts and 32
# new tokens (text only), as for smollm-360m. The card against the CPU:
# the first CHIP_CPU_LAYERS layers' prefill in f32 activations at B=1,
# S=CHIP_CPU_SEQ (256 patches and 256 text tokens).
CHIP_LAYERS = 8
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_CPU_LAYERS, CHIP_CPU_SEQ = 2, 512
