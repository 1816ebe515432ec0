"""deepseek-coder-33b [dense]: llama-arch (arXiv:2401.14196).

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256, head_dim=128.
The same configurations as ``repro.configs.deepseek_coder_33b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke", family="dense",
    n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=320, vocab=512, head_dim=16, activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width. The 62 layers' f32
# weights (133.4 GB) do not fit one 80 GB card, so it runs 8 layers
# (18.8 GB); the prefill_32k cell cut to B=4 prompts of S=2048 and a
# decode of 4 requests of 16-token prompts and 32 new tokens, as for
# smollm-360m. Its f32-activation check runs the first CHIP_F32_LAYERS.
CHIP_LAYERS = 8
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_F32_LAYERS = 4
