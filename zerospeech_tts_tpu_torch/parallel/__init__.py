"""Multi-device execution of the PyTorch port (counterpart of
``zerospeech_tts_tpu/parallel/``): the ``data`` and ``model`` axes.

Training runs one process a card (torchrun): data-parallel over ``data``
(an explicit gradient all_reduce in ``train/solver.py``, batch rows or
corpus shards per data rank) and tensor-parallel over ``model`` (each rank
keeps its blocks of the large parameters and their Adam moments, and a
step gathers the whole weights it reads: ``mesh.ModelShards``); conversion
splits each dispatch's rows over the cards of one process
(``convert.Converter(devices=)``).
"""

from zerospeech_tts_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier,
    destroy,
    initialize,
    is_primary,
    launch,
    local_device,
    mesh_groups,
    rank,
    world,
)
from zerospeech_tts_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_slice,
    conversion_devices,
    device0_bytes,
    param_shardings,
    parse_mesh,
    place_state,
    replicate_state,
    shard_state,
    state_tree,
)
