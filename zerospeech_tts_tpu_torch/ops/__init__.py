"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions: fused frontend (kernel 1), GRU recurrence (kernel 2, in f32 and
in bf16), GRU backward pass (kernel 3, in ops/gru.py beside kernel 2) and
fast Griffin-Lim (kernel 4). Numbering follows the four Pallas kernels of
the JAX package; kernel 2's bf16 mode (``gru_bf16``) is the bf16 mode of
``pallas_gru_scan``, a kernel of its own (``csrc/gru_bf16.cu``) behind the
same wrapper as ``gru``."""

from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim, gru

# name -> (module, name of its launch counter, its source csrc/<source>.cu)
KERNELS = {
    "frontend": (frontend, "launches", "frontend"),
    "gru": (gru, "launches", "gru"),
    "gru_bf16": (gru, "bf16_launches", "gru_bf16"),
    "gru_bwd": (gru, "bwd_launches", "gru_bwd"),
    "griffin_lim": (griffin_lim, "launches", "griffin_lim"),
}
SOURCES = sorted({src for _, _, src in KERNELS.values()})


def reset_launches() -> None:
    for mod, attr, _ in KERNELS.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr, _) in KERNELS.items()}


def add_launches(counts: dict[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (kernel name -> launches) to the
    counters: a CUDA graph's replay runs the launches its capture made,
    and the capture itself runs none."""
    for name, n in counts.items():
        mod, attr, _ = KERNELS[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)
