"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device(device), refusing a CUDA device when torch sees none:
    a missing card is an error, never a quiet run on the CPU ("cpu" runs
    the plain torch twins)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: torch sees no CUDA device "
                           f"(pass device='cpu' for the plain torch decoders)")
    return dev
