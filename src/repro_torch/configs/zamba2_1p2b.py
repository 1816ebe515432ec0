"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks
(arXiv:2411.15242).

38L d_model=2048, ssm_state=64, head_dim=64 (H=64), expand=2;
one weight-shared GQA block (32H, d_ff=8192) applied every 6 layers.
vocab=32000.
The same configurations as ``repro.configs.zamba2_1p2b``.
"""

from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, n_groups=1,
                  conv_width=4, chunk=256),
    hybrid=HybridConfig(period=6, shared_d_ff=8192, shared_n_heads=32,
                        shared_n_kv_heads=32),
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, chunk=8),
    hybrid=HybridConfig(period=2, shared_d_ff=128, shared_n_heads=4,
                        shared_n_kv_heads=4),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width, cut to 12 of the 38
# Mamba2 layers and so 2 of the shared block's 6 applications (the
# script's time limit, shared with the other archs, caps the host-bound
# decode loops); the prefill_32k cell cut to B=4 prompts of S=2048 and a decode
# of 4 requests of 16-token prompts and 32 new tokens, as for
# smollm-360m. Decode against prefill runs CHIP_CHECK_SEQ teacher-forced
# steps (a multiple of the 256-token chunk); one Mamba2 layer runs on the
# card and the CPU at B=1, S=CHIP_CPU_SEQ. long_500k: one decode step at
# B=1 with a bf16 cache of CHIP_LONG_LEN positions at its last position
# (the shared block's K/V: 2·524288·32·64·2·2 B = 8.6 GB at 12 layers).
CHIP_LAYERS = 12
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
CHIP_CHECK_SEQ = 256
CHIP_CPU_SEQ = 512
CHIP_LONG_LEN = 524288
