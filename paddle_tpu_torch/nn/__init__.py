"""``paddle.nn`` of the port.  The models build on ``torch.nn``; this
package holds the reference's layers that ``torch.nn`` does not match,
so far ``CrossEntropyLoss``."""
from .layer import CrossEntropyLoss

__all__ = ["CrossEntropyLoss"]
