"""The port's device rule: ``None`` means CUDA, and CUDA must exist."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent, so an
    entry point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def check_module_device(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless every parameter of ``module`` lies on ``device``."""
    for p in module.parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(
                f"{type(module).__name__} parameters are on {p.device}, the "
                f"call asked for {device}; move the module with .to(device)")
