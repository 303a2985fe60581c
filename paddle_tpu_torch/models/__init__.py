"""Models of the port."""
from .convert import gpt_state_from_paddle_tpu
from .gpt import GPT, GPTAttention, GPTBlock, GPTConfig

__all__ = ["GPT", "GPTAttention", "GPTBlock", "GPTConfig",
           "gpt_state_from_paddle_tpu"]
