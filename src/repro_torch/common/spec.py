"""Shape and type of a tensor that is not allocated: the leaves of the
parameter, cache and optimizer-state specs."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class TensorSpec(NamedTuple):
    """Shape and type of one parameter or cache leaf."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
