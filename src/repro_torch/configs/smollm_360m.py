"""smollm-360m [dense]: llama-arch small (hf:HuggingFaceTB/SmolLM family).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152, head_dim=64.
The same configurations as ``repro.configs.smollm_360m``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, head_dim=64, rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=3, n_kv_heads=1,
    d_ff=256, vocab=512, head_dim=32, activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width. The prefill is the
# prefill_32k cell (S=32768 at a global batch of 32, configs/registry.py)
# cut to B=4 prompts of S=2048, every width kept; one kernel launch still
# runs at S=32768, B=1 (that cell's per-sequence shape). Decode serves 4
# requests of 16-token prompts and 32 new tokens (launch/serve.py's
# defaults are 4, 8 and 16).
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_LONG_SEQ = 32768
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32

# The size chip_smoke.py trains at full width: the train_4k cell (S=4096
# at a global batch of 256, configs/registry.py) cut in batch only, to B=4
# sequences on one card; every width and all 32 layers kept, bf16
# activations and f32 master weights as CONFIG has them. Its plain-version
# check runs 4 layers in f32 activations at B=1, S=2048 (the simple flash
# design), and its kill/resume check the SMOKE config for 4 steps.
CHIP_TRAIN_BATCH, CHIP_TRAIN_SEQ = 4, 4096
CHIP_TRAIN_F32_LAYERS, CHIP_TRAIN_F32_BATCH, CHIP_TRAIN_F32_SEQ = 4, 1, 2048
CHIP_TRAIN_RESUME_STEPS, CHIP_TRAIN_RESUME_KILL = 4, 2
