"""Device resolution for the port's entry points.

Entry points run on the card by default.  Without a card they raise unless
the caller asked for the CPU explicitly: a run never drops to the CPU on its
own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> "cuda".  A CUDA device without a card raises RuntimeError."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
