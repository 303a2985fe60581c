"""``paddle.autograd`` of the port — the counterpart of
``paddle_tpu/autograd.py``: ``PyLayer``, ``PyLayerContext``, ``backward``,
``grad`` and the grad-mode switches, on torch autograd
(``core/autograd.py``).  The functional transforms (``vjp``, ``jvp``,
``jacobian``, ``hessian``, ``autograd_functional.py``) are ``ROADMAP.md``
§A item 5b."""
from .core import autograd as backward_mode  # noqa: F401
from .core.autograd import (PyLayer, PyLayerContext, backward,  # noqa: F401
                            enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)

no_grad_ = no_grad
