"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or "cuda" when it is None; raises when it is None and no
    card is present (the CPU path runs every op's plain version, and only
    a caller who asks for it gets it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)
