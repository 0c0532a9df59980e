"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent —
    the port never moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def uninitialized(factory, device: Optional[Union[str, torch.device]] = None):
    """`factory(device)` built on the meta device, with no init (the port's
    `_trunc_normal_` skips meta tensors), then given uninitialized storage on
    `device` (default `cuda`): for a module whose every parameter and buffer
    the caller loads next."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = factory(torch.device("meta"))
    return module.to_empty(device=dev)
