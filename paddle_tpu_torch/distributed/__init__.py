"""``paddle.distributed`` of the port: verified, atomic checkpoints
(:mod:`.checkpoint`, the reference's ``distributed/checkpoint.py``).  The
collectives, meshes, fleet and launch are not ported yet (``ROADMAP.md``
§A item 8, A5)."""
from . import checkpoint

__all__ = ["checkpoint"]
