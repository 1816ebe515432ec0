"""The LM stack of the torch package: the dense family (GQA decoder), the
moe family (GQA or MLA attention, fine-grained MoE FFN), Mamba2 (ssm)
and the hybrid (Mamba2 + a shared attention block), the encoder-decoder
(encdec) and the vision-language model (vlm) over stubbed frontends."""

from .config import ModelConfig  # noqa: F401
from .zoo import Model  # noqa: F401
