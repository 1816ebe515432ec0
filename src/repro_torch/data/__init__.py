"""Deterministic, seekable synthetic data pipelines."""

from .pipeline import TokenPipeline, cube_loader  # noqa: F401
