"""Models of the port: the eager GPT (``gpt``, serving) and the
one-device compiled-trainer path of the flagship GPT (``gpt_spmd``);
``convert`` carries the reference's weights across, the fused
transformer layers' too."""
from .convert import (fused_transformer_state_from_paddle_tpu,
                      gpt_spmd_state_from_paddle_tpu,
                      gpt_state_from_paddle_tpu)
from .gpt import GPT, GPTAttention, GPTBlock, GPTConfig
from .gpt_spmd import build_spmd_train_step

__all__ = ["GPT", "GPTAttention", "GPTBlock", "GPTConfig",
           "build_spmd_train_step", "fused_transformer_state_from_paddle_tpu",
           "gpt_spmd_state_from_paddle_tpu",
           "gpt_state_from_paddle_tpu"]
