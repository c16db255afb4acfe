"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions: fused frontend (kernel 1), GRU recurrence (kernel 2), GRU
backward pass (kernel 3, in ops/gru.py beside kernel 2) and fast
Griffin-Lim (kernel 4). Numbering follows the four Pallas kernels of the
JAX package. Each kernel's name is its source ``csrc/<name>.cu``."""

from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim, gru

# name -> (module, name of its launch counter)
KERNELS = {
    "frontend": (frontend, "launches"),
    "gru": (gru, "launches"),
    "gru_bwd": (gru, "bwd_launches"),
    "griffin_lim": (griffin_lim, "launches"),
}


def reset_launches() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}
