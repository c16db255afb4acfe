"""Training runtime of the PyTorch port: solver, checkpoints, logging."""

from zerospeech_tts_tpu_torch.train.checkpoint import CheckpointManager
from zerospeech_tts_tpu_torch.train.logger import Logger
from zerospeech_tts_tpu_torch.train.solver import Solver, TrainState, init_state

__all__ = ["CheckpointManager", "Logger", "Solver", "TrainState", "init_state"]
