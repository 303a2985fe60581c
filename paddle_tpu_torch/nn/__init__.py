"""``paddle.nn`` of the port — the counterpart of
``paddle_tpu/nn/__init__.py``: ``Layer`` (``layer_base``), ``ParamAttr``,
``initializer``, ``functional``, the layers of ``nn/layer/`` (common,
activation, norm, container, transformer, the recurrent layers and beam
search, the 16 loss layers), the gradient clips (``clip``),
``Parameter`` and ``utils`` (``spectral_norm``, ``weight_norm``,
``remove_weight_norm``, also here).  ``torch_view`` gives port code
torch's view of a network."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa: F401,E501
from .layer import *  # noqa: F401,F403
from .layer import CrossEntropyLoss  # noqa: F401
from .layer_base import Layer, torch_view  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from ..core.tensor import Parameter  # noqa: F401
from . import utils_mod as utils  # noqa: F401
from .utils_mod import (remove_weight_norm, spectral_norm,  # noqa: F401
                        weight_norm)
