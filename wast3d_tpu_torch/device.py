"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means CUDA. A CUDA device without a usable card raises
    `RuntimeError`: the port never falls back to the CPU on its own; the
    caller asks for it with `device="cpu"` (as the CPU tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
