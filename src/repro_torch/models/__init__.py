"""The LM stack of the torch package: the dense family (GQA decoder)."""

from .config import ModelConfig  # noqa: F401
from .zoo import Model  # noqa: F401
