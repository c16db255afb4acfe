"""Encoder, decoder and MBV discretizer of the PyTorch port."""

from zerospeech_tts_tpu_torch.models.decoder import Decoder
from zerospeech_tts_tpu_torch.models.encoder import Encoder
from zerospeech_tts_tpu_torch.models.mbv import discretize, hard_units, unit_bits

__all__ = ["Decoder", "Encoder", "discretize", "hard_units", "unit_bits"]
