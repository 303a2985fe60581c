"""Operators of the port: ``flash_attention`` (the hand-written CUDA
flash-attention forward with its plain PyTorch version) and ``nn_misc``
(the attention entry point).  Import them from their modules."""
