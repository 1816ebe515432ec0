"""mamba2-2.7b [ssm]: SSD, attention-free (arXiv:2405.21060).

64L d_model=2560, ssm_state=128, head_dim=64 (H=80), expand=2,
vocab=50280. The paper's SFC technique is inapplicable to the SSD
recurrence (DESIGN.md §Arch-applicability) — arch implemented without it.
The same configurations as ``repro.configs.mamba2_2p7b``.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    vocab_pad_multiple=256,
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                  conv_width=4, chunk=256),
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=4, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0, vocab=512,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=8),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width and full depth: all 64
# layers (11.3 GB of f32 weights); the prefill_32k cell cut to B=4 prompts
# of S=2048 (8 SSD chunks of 256) and a decode of 4 requests of 16-token
# prompts and 32 new tokens, as for smollm-360m. Decode against prefill
# runs CHIP_CHECK_SEQ teacher-forced steps (the prefill's length must be a
# multiple of the 256-token chunk); one layer runs on the card and the CPU
# at B=1, S=CHIP_CPU_SEQ (two chunks, so the state crosses one boundary).
# long_500k: one decode step at B=1, cur=CHIP_LONG_LEN - 1 (the state is
# the same size at any position).
CHIP_LAYERS = 64
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_CHECK_SEQ = 256
CHIP_CPU_SEQ = 512
CHIP_LONG_LEN = 524288
