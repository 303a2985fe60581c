"""``paddle.nn`` of the port.  The models build on ``torch.nn``; this
package holds the reference's layers that ``torch.nn`` does not match,
so far ``CrossEntropyLoss``, and the gradient clips (``nn/clip.py``)."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import CrossEntropyLoss

__all__ = ["CrossEntropyLoss", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
