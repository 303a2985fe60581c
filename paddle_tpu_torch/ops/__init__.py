"""Operators of the port: ``flash_attention`` (the hand-written CUDA
flash-attention forward and backward with their plain PyTorch versions),
``flash_attention_qkv`` (the same kernels on a packed projection),
``softmax_xent`` (the fused LM-head loss), ``nn_misc`` (the attention
entry point) and ``loss`` (cross entropy).  Import them from their
modules."""
