"""The eager core — the counterpart of ``paddle_tpu/core/``: dtypes
(``dtype``), the enforce taxonomy (``errors``), places (``place``),
``Tensor`` / ``Parameter`` / ``to_tensor`` (``tensor``), autograd on torch
autograd (``autograd``), the op dispatch (``dispatch``) and the random
state (``random``)."""
