"""whisper-small [audio]: enc-dec backbone, conv frontend stubbed
(arXiv:2212.04356).

12L(dec)+12L(enc) d_model=768 12H d_ff=3072 vocab=51865; encoder sees
1500 precomputed frame embeddings (``input_specs`` provides them).
Decoder uses RoPE instead of whisper's learned 448-position table so the
assigned 32k stress shapes are well-defined (DESIGN.md §5).
The same configurations as ``repro.configs.whisper_small``.
"""

from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    vocab_pad_multiple=256,
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    encdec=EncDecConfig(n_enc_layers=12, n_frames=1500),
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, head_dim=24,
    encdec=EncDecConfig(n_enc_layers=2, n_frames=16),
    activation_dtype="float32",
)

# The sizes chip_smoke.py serves at full width and full depth: 12 decoder
# and 12 encoder layers (1.3 GB of f32 weights) over frames of
# (B, 1500, 768); the prefill_32k cell cut to B=4 prompts of S=2048 and a
# decode of 4 requests of 16-token prompts and 32 new tokens, as for
# smollm-360m. The cross cache of the decode-against-prefill check is
# filled from the encoder's output on the prefill's frames.
CHIP_LAYERS = 12
CHIP_PREFILL_BATCH, CHIP_PREFILL_SEQ = 4, 2048
CHIP_DECODE_BATCH, CHIP_PROMPT_LEN, CHIP_NEW_TOKENS = 4, 16, 32
