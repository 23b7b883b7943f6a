"""Device resolution for every entry point of the port.

The port runs on the card.  An entry point given no device takes
``cuda`` and raises when there is none; the CPU is used only when the
caller names it (as the tests do).  Nothing falls back quietly.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises if the resolved device is a CUDA
    device and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev

