"""Array containers and the plain PyTorch versions of the engine ops."""
from repro_torch.engine_backend.pytrees import (PollGrid, ReadingSchedule,
                                                TimelineArrays)

__all__ = ["PollGrid", "ReadingSchedule", "TimelineArrays"]
