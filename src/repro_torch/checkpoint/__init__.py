"""Atomic, manifest-driven, elastic checkpointing (the torch counterpart
of ``repro.checkpoint``; the on-disk format is the same)."""

from . import ckpt  # noqa: F401
from .ckpt import (  # noqa: F401
    CheckpointCorruptError, latest_step, restore, save, save_async,
    valid_steps, wait,
)
