"""``paddle.autograd`` of the port — the counterpart of
``paddle_tpu/autograd.py``: ``PyLayer``, ``PyLayerContext``, ``backward``,
``grad`` and the grad-mode switches, on torch autograd
(``core/autograd.py``), and the functional transforms ``vjp``, ``jvp``,
``jacobian`` and ``hessian`` (``autograd_functional.py``, where ``vhp``
is too), as the reference's ``autograd.py:5`` exports them."""
from .autograd_functional import hessian, jacobian, jvp, vjp  # noqa: F401
from .core import autograd as backward_mode  # noqa: F401
from .core.autograd import (PyLayer, PyLayerContext, backward,  # noqa: F401
                            enable_grad, grad, is_grad_enabled, no_grad,
                            set_grad_enabled)

no_grad_ = no_grad
