"""Serving: the LM decode step and the batched greedy decode loop."""

from .serve_step import greedy_decode, make_serve_step  # noqa: F401
