"""The LM stack of the torch package: the dense family (GQA decoder) and
the moe family (GQA or MLA attention, fine-grained MoE FFN)."""

from .config import ModelConfig  # noqa: F401
from .zoo import Model  # noqa: F401
