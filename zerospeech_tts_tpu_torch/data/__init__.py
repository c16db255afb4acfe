"""Data of the PyTorch port: corpus builder (single-process or sharded,
with the native wav decoder), segment index, host segment loader,
on-device arena sampler and per-speaker normalization."""
