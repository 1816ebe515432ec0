"""deepseek-moe-16b [moe]: fine-grained expert segmentation (arXiv:2401.06066).

28L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=102400.
MoE: 2 shared + 64 routed, top-6, first layer dense.
The same configurations as ``repro.configs.deepseek_moe_16b``.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                  first_k_dense=1),
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke", family="moe",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, head_dim=24,
    moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_ff_expert=64,
                  first_k_dense=1, capacity_factor=4.0),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width: 8 layers (the dense one and
# 7 MoE layers, 18.5 GB of f32 weights; deepseek-v2-lite-16b runs the MoE
# family at full depth, and all 28 layers here would take 65.5 GB and
# about as long again); the prefill_32k cell cut to B=4 prompts of
# S=2048 and a decode of 4 requests of 16-token prompts and 32 new tokens,
# as for smollm-360m. The card against the CPU: the first CHIP_CPU_LAYERS
# layers in f32 activations at B=1, S=CHIP_CPU_SEQ.
CHIP_LAYERS = 8
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_CPU_LAYERS, CHIP_CPU_SEQ = 2, 256
