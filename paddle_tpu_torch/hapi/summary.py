"""``summary`` and ``flops`` — the counterparts of
``paddle_tpu/hapi/summary_mod.py`` (:12, :69).

Both run one forward of the network in eval mode (its mode restored
after) on zeros of the given sizes, on the device of its parameters,
with forward hooks on its modules.  ``summary`` prints the reference's
table, one row per leaf module in the order they ran, with its output
shape and parameter count, then the totals, and returns the totals;
ids go in through ``dtypes`` (``"int64"``).  ``flops`` counts the
reference's rough products: ``2·k·C_in/groups`` per output element of a
convolution and ``2·in_features`` per output element of a ``Linear``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["summary", "flops"]


def _dtype(name) -> torch.dtype:
    """A torch dtype from a dtype or its name (``"float32"``,
    ``"int64"``, ...)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _first(outputs):
    return outputs[0] if isinstance(outputs, (tuple, list)) else outputs


def _run(net: nn.Module, inputs) -> None:
    """One forward of ``net`` on ``inputs`` in eval mode, without grad."""
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        if was_training:
            net.train()


def _device(net: nn.Module) -> torch.device:
    p = next(net.parameters(), None)
    return p.device if p is not None else torch.device("cpu")


def summary(net: nn.Module, input_size=None, dtypes=None, input=None):
    """Print each leaf module's output shape and parameters, then the
    totals; returns ``{"total_params": n, "trainable_params": m}``."""
    rows = []

    def make_hook(name):
        def hook(module, inputs, outputs):
            out = _first(outputs)
            shape = list(out.shape) if isinstance(out, torch.Tensor) \
                else "?"
            n_params = sum(p.numel() for p in module.parameters(
                recurse=False))
            rows.append((name, type(module).__name__, shape, n_params))
        return hook

    if input is not None:
        x = list(input) if isinstance(input, (list, tuple)) else [input]
    else:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes or "float32"] * len(sizes)
        dev = _device(net)
        x = [torch.zeros(list(s), dtype=_dtype(dt), device=dev)
             for s, dt in zip(sizes, dts)]
    hooks = [sub.register_forward_hook(make_hook(name))
             for name, sub in net.named_modules()
             if name and not any(True for _ in sub.children())]
    try:
        _run(net, x)
    finally:
        for h in hooks:
            h.remove()

    total_params = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    width = 76
    print("-" * width)
    print(f"{'Layer (type)':<34}{'Output Shape':<26}{'Param #':<12}")
    print("=" * width)
    for name, tname, shape, n in rows:
        print(f"{name + ' (' + tname + ')':<34}{str(shape):<26}{n:<12,}")
    print("=" * width)
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total_params - trainable:,}")
    print("-" * width)
    return {"total_params": total_params, "trainable_params": trainable}


def flops(net: nn.Module, input_size, custom_ops=None, print_detail=False):
    """The products' operations of one forward on fp32 zeros of
    ``input_size``: convolutions and ``Linear`` layers (``custom_ops`` is
    taken and not read, as in the reference)."""
    total = [0]

    def conv_hook(module, inputs, outputs):
        k = math.prod(module.kernel_size)
        cin = module.in_channels // module.groups
        total[0] += 2 * k * cin * _first(outputs).numel()

    def linear_hook(module, inputs, outputs):
        total[0] += 2 * module.in_features * _first(outputs).numel()

    hooks = []
    for name, sub in net.named_modules():
        if not name:          # the network itself, as in the reference
            continue
        if isinstance(sub, nn.modules.conv._ConvNd):
            hooks.append(sub.register_forward_hook(conv_hook))
        elif isinstance(sub, nn.Linear):
            hooks.append(sub.register_forward_hook(linear_hook))
    try:
        _run(net, [torch.zeros(list(input_size), device=_device(net))])
    finally:
        for h in hooks:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
