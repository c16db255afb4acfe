"""The benchmark of zerospeech_tts_tpu_torch, the PyTorch and CUDA port (see README.md)."""
