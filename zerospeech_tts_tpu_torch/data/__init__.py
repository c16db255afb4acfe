"""Data of the PyTorch port: corpus builder, on-device arena sampler and
per-speaker normalization."""
