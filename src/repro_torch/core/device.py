"""Device selection for the torch package's entry points.

Every entry point runs on the card unless the caller asks for the CPU.
Asking for CUDA on a machine without it raises here; nothing carries on
silently on the CPU. On a CPU tensor the kernel wrappers run their plain
PyTorch versions (kernels/ref.py), which is what the CPU tests use.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device") -> torch.device:
    """Validate ``device`` ("cuda", "cuda:N" or "cpu") and return it."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev
