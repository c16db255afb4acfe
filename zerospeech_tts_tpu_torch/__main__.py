"""``python -m zerospeech_tts_tpu_torch`` -> the port's CLI (cli.py)."""

from zerospeech_tts_tpu_torch.cli import main

main()
