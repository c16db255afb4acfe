"""Audio DSP of the PyTorch port: frontend and vocoder (audio), mel
filterbank (mel), wav IO and silence trim (wavio), the mu-law PCM wire
(mulaw)."""
