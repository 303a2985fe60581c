"""Layers of the port (``paddle_tpu/nn/layer/``): ``common``,
``activation``, ``norm``, ``container``, ``transformer`` and the loss
layers."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
