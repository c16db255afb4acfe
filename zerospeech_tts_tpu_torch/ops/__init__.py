"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
versions: fused frontend (kernel 1), GRU recurrence (kernel 2), fast
Griffin-Lim (kernel 4). Numbering follows the four Pallas kernels of the
JAX package; kernel 3 (the GRU backward pass) belongs to training, which is
not ported yet."""

from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim, gru

KERNELS = {"frontend": frontend, "gru": gru, "griffin_lim": griffin_lim}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}
