"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a :class:`torch.device`, refusing CUDA when there is
    none: the port never falls back to the CPU on its own.  A CUDA device
    without an index gets the current one, as the tensors made on it
    report it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: this entry point runs on the card "
                "by default; pass device=\"cpu\" to run the plain PyTorch "
                "path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
