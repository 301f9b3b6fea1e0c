"""Device helpers for the port.

The serving path runs on the card.  It never falls back to the CPU on its
own: a caller who wants the CPU (the tests, the reference run of
``chip_smoke.py``) says so by putting the model and inputs there.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's serving path runs on an NVIDIA GPU "
            "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    device = tensors[0].device
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != device:
            raise ValueError(
                f"{name}: tensors on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def cpu_or_raise(name: str, tensor: torch.Tensor) -> None:
    """The plain version runs on CPU tensors only; anything else raises."""
    if tensor.device.type != "cpu":
        raise ValueError(
            f"{name}: no kernel for device {tensor.device} (CUDA tensors "
            "launch the kernel, CPU tensors take the plain version)")
