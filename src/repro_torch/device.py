"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the CUDA device; raises when CUDA is
    asked for and there is none (the port never falls back to the CPU
    on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
