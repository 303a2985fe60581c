"""``paddle.callbacks`` of the port (reference ``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (Callback, EarlyStopping,  # noqa: F401
                             LRSchedulerCallback as LRScheduler,
                             ModelCheckpoint, ProfilerCallback,
                             ProgBarLogger, VisualDL)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "VisualDL", "ProfilerCallback"]
