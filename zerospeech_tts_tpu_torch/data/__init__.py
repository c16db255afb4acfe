"""Data helpers of the PyTorch port (per-speaker normalization)."""
