"""The port's device rule: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device for the port's tensors.  CUDA is the default everywhere;
    asking for it without a card raises — nothing drops to the CPU on its
    own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path")
    return dev
