"""``paddle.utils`` of the port: the flag registry (:mod:`.flags`)."""
from . import flags
from .flags import all_flags, get_flag, get_flags, set_flags

__all__ = ["flags", "all_flags", "get_flag", "get_flags", "set_flags"]
