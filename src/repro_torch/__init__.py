"""PyTorch + CUDA port of the SFC stencil system (``repro`` is the JAX one).

Sub-packages mirror ``repro``: ``core`` (curves, boundaries, layouts,
neighbour tables), ``kernels`` (hand-written CUDA kernels for Hopper with
their plain PyTorch versions), ``stencil`` (the resident pipeline and the
gol3d application) and ``configs``. The package imports torch and numpy,
never JAX. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
