"""The ``data`` axis of the PyTorch port's mesh (counterpart of the DP half
of ``zerospeech_tts_tpu/parallel/mesh.py`` and of the JAX CLI's
``_mesh_from_arg``).

``--mesh data=D`` shards the batch over D cards: D processes, one a card,
for training (each holds its rows, ``batch_slice``), or D cards of one
process for conversion (``conversion_devices``). Rows are laid out as
JAX's ``P("data")`` lays them: rank r owns the r-th contiguous block.
Tensor parallelism over a ``model`` axis is not ported yet.
"""

from __future__ import annotations

import torch

MODEL_AXIS_REFUSAL = (
    "--mesh model={m}: tensor parallelism over the 'model' axis (the JAX package's "
    "param_shardings / shard_state / place_state / device0_bytes, parallel/mesh.py:37-107) "
    "is a later slice of the port (ROADMAP.md); use --mesh data=D"
)


def parse_mesh(spec: str | None, n_devices: int | None = None) -> int:
    """The data-axis size of ``"data=D[,model=M]"`` (None or "" -> 1). As
    JAX's make_mesh: ``data`` left out means n_devices // model, and a mesh
    of more than ``n_devices`` raises ValueError("... needs N devices, have
    K"). ``model`` above 1 exits with a message (not ported)."""
    if not spec:
        return 1
    axes = {}
    for part in spec.split(","):
        k, sep, v = part.partition("=")
        if not sep or k.strip() not in ("data", "model"):
            raise ValueError(f"--mesh {spec!r}: want data=D[,model=M]")
        axes[k.strip()] = int(v)
    model = axes.get("model", 1)
    if model > 1:
        raise SystemExit(MODEL_AXIS_REFUSAL.format(m=model))
    data = axes.get("data")
    if data is None:
        if n_devices is None:
            raise ValueError(f"--mesh {spec!r}: name the data axis (data=D)")
        data = n_devices // model
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {spec!r}: axis sizes must be positive")
    if n_devices is not None and data * model > n_devices:
        raise ValueError(f"mesh data={data} x model={model} needs {data * model} devices, have {n_devices}")
    return data


def batch_slice(rank: int, world: int, n: int) -> slice:
    """The rows of an ``n``-row batch that ``rank`` of ``world`` owns: the
    rank-th of ``world`` equal contiguous blocks (JAX: ``n % data`` must be
    0 to shard a batch over the axis)."""
    if n % world:
        raise ValueError(f"batch of {n} rows does not divide over {world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def conversion_devices(device: str | torch.device, data: int) -> list[torch.device]:
    """The devices one conversion process splits its batches over: for
    ``cuda``, cards 0..data-1 (raising when fewer are visible); for the CPU,
    the CPU ``data`` times (the split itself, on one device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * data
    n = torch.cuda.device_count()
    if data > n:
        raise ValueError(f"mesh data={data} x model=1 needs {data} devices, have {n} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(data)]
