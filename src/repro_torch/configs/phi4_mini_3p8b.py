"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA (arXiv:2412.08905).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, head_dim=128.
The same configurations as ``repro.configs.phi4_mini_3p8b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=16, activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width, cut to 8 of the 32
# layers (the script's time limit, shared with the other archs, caps the
# host-bound decode loops): the prefill_32k cell cut to B=4 prompts of S=2048 and a
# decode of 4 requests of 16-token prompts and 32 new tokens, as for
# smollm-360m. Its f32-activation check runs the first CHIP_F32_LAYERS.
CHIP_LAYERS = 8
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_F32_LAYERS = 4
