"""gemma3-1b [dense]: 5:1 local:global sliding-window (hf:google/gemma-3-1b-pt).

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144, head_dim=256,
window=512, global layer every 6th, global rope theta 1e6.
The same configurations as ``repro.configs.gemma3_1b``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    sliding_window=512, global_every=6,
    rope_theta=1e4, global_rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", family="dense",
    n_layers=4, d_model=96, n_heads=2, n_kv_heads=1,
    d_ff=256, vocab=512, head_dim=48,
    sliding_window=8, global_every=2,
    rope_theta=1e4, global_rope_theta=1e6, activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width, cut to 12 of the 26
# layers (two local:global periods; the script's time limit, shared with
# the other archs, caps the host-bound decode loops): the prefill_32k cell cut to B=4 prompts of S=2048 and a
# decode of 4 requests of 16-token prompts and 32 new tokens, as for
# smollm-360m. The window check runs the first CHIP_WINDOW_LAYERS layers
# (five local, one global) and fills the cache by teacher-forced decode
# steps to CHIP_WINDOW_SEQ positions, past the 512-position window.
CHIP_LAYERS = 12
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_WINDOW_LAYERS, CHIP_WINDOW_SEQ = 6, 520
