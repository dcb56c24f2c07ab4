"""Device resolution shared by the port's entry points."""

from typing import Optional, Union

import torch


def indexed(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its index: a bare ``cuda`` becomes the current
    card, ``cuda:<current_device()>``, so that two names of one card
    compare equal and a kernel launches on the card its tensors live on.
    Other devices come back as they are."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the current card, returned with its index. Without
    one, raise rather than carry on quietly on the CPU: only an explicit
    ``device="cpu"`` runs there."""
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return indexed(device)
