"""Encoder, decoder, MBV discretizer, speaker classifier and patch
discriminator of the PyTorch port."""

from zerospeech_tts_tpu_torch.models.classifier import SpeakerClassifier
from zerospeech_tts_tpu_torch.models.decoder import Decoder
from zerospeech_tts_tpu_torch.models.encoder import Encoder
from zerospeech_tts_tpu_torch.models.mbv import discretize, hard_units, unit_bits
from zerospeech_tts_tpu_torch.models.patch_discriminator import PatchDiscriminator

__all__ = ["Decoder", "Encoder", "PatchDiscriminator", "SpeakerClassifier", "discretize",
           "hard_units", "unit_bits"]
