"""Device resolution for the port's entry points.

Entry points run on the card by default.  Without a card they raise unless
the caller asked for the CPU explicitly: a run never drops to the CPU on its
own.

Under data parallelism (parallel/dist.py) each process drives one card:
with the MEDSEG_* variables set, the default device is the rank's card,
`cuda:{MEDSEG_PROCESS_ID % torch.cuda.device_count()}`.  An explicit device
still wins.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def rank_device(env: Mapping[str, str] = os.environ) -> torch.device:
    """The card of this process: cuda:{MEDSEG_PROCESS_ID % device count}
    when MEDSEG_COORDINATOR and MEDSEG_PROCESS_ID are set, else "cuda" (the
    current card).  Reads no card without the variables."""
    if env.get("MEDSEG_COORDINATOR") and env.get("MEDSEG_PROCESS_ID") is not None:
        count = torch.cuda.device_count()
        if count:
            return torch.device("cuda", int(env["MEDSEG_PROCESS_ID"]) % count)
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None -> the rank's card (rank_device).  A CUDA device without a card
    raises RuntimeError."""
    dev = rank_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
