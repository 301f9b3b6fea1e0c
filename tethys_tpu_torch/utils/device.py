"""Device helpers for the port.

Every path runs on the card.  None falls back to the CPU on its own: a
caller who wants the CPU (the tests, the reference runs of
``chip_smoke.py``, ``--device cpu``) says so by putting the model and
inputs there.
"""

from __future__ import annotations

import subprocess

import torch


def require_cuda() -> torch.device:
    """The first CUDA device, or RuntimeError when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU unless the caller "
            "asks for the CPU "
            "(torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def card_name_and_power() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (the first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def host_to_device(tensor: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  To the card it goes through pinned
    memory as a non-blocking copy, so the host does not wait for the work
    already queued on the device (a copy from pageable memory would)."""
    device = torch.device(device)
    if tensor.device == device:
        return tensor
    if device.type == "cuda" and tensor.device.type == "cpu":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)
