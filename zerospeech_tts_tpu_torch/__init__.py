"""PyTorch + CUDA (Hopper) port of zerospeech_tts_tpu, beside the JAX package.

The first slice is conversion straight from wavs in the challenge-exact
configuration: frontend -> encoder -> MBV units -> decoder for every target
-> Griffin-Lim -> PCM16. The frontend, the GRU recurrence and Griffin-Lim
run in hand-written CUDA kernels (csrc/, built with nvcc for sm_90a at
first use) on CUDA tensors and in their plain PyTorch versions on CPU
tensors. This package never imports JAX or the JAX package.
"""

import torch

from zerospeech_tts_tpu_torch.config import AudioConfig, Hps, load_configs

# The exact configuration is f32 end to end. Matmuls default to full f32 on
# the card, but cuDNN convolutions default to TF32 (about three decimal
# digits), which flips borderline units; both are pinned off here, at
# import of the package.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["AudioConfig", "Hps", "load_configs"]
