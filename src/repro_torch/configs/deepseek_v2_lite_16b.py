"""deepseek-v2-lite-16b [moe]: MLA + fine-grained MoE (arXiv:2405.04434).

27L d_model=2048 16H d_ff=1408(expert) vocab=102400.
MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128.
MoE: 64 routed + 2 shared, top-6, first layer dense.
The same configurations as ``repro.configs.deepseek_v2_lite_16b``, which
follows the "64e top-6" of DeepSeek-V2-Lite (160 routed experts are
DeepSeek-V2's, 236B; DESIGN.md §5).
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                  first_k_dense=1),
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab=512, head_dim=24,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
    moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_ff_expert=64,
                  first_k_dense=1, capacity_factor=4.0),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width, all 27 layers (62.8 GB of
# f32 weights, so the card's earlier phases free their tensors first): the
# prefill_32k cell cut to B=4 prompts of S=2048 and a decode of 4 requests
# of 16-token prompts and 32 new tokens, as for smollm-360m. The card
# against the CPU: the first CHIP_CPU_LAYERS layers (the dense one and one
# MoE layer) in f32 activations at B=1, S=CHIP_CPU_SEQ.
CHIP_LAYERS = 27
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_CPU_LAYERS, CHIP_CPU_SEQ = 2, 256
