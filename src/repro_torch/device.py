"""The device an entry point of the port runs on, the way host data
goes up to it, and the places the port waits for it on purpose."""
from __future__ import annotations

import contextlib

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


def upload(x, device=None) -> torch.Tensor:
    """``x`` (a tensor, array or number) as a tensor on ``device``
    (``None``: where it is). A CPU tensor goes up to a CUDA device
    without a host sync: through pinned memory, copied asynchronously in
    stream order (a blocking copy from pageable memory waits for the
    whole stream first); the caching host allocator keeps the pinned
    buffer until the copy is done."""
    t = torch.as_tensor(x)
    dev = t.device if device is None else torch.device(device)
    if dev.type != "cuda" or t.device.type != "cpu":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


@contextlib.contextmanager
def fetch_point():
    """Where the port waits for the device on purpose (a blessed fetch
    or wait of the contract registry, ``analysis/compile_sites.toml``):
    a sync sanitizer armed around a run (``torch.cuda
    .set_sync_debug_mode``, ``analysis.sanitizer.sync_sanitizer``) is
    lifted inside and restored after, so only an implicit sync trips
    it."""
    prev = torch.cuda.get_sync_debug_mode() \
        if torch.cuda.is_initialized() else 0
    if prev:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            torch.cuda.set_sync_debug_mode(prev)
