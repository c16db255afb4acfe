"""Multi-device execution of the PyTorch port (counterpart of
``zerospeech_tts_tpu/parallel/``): the ``data`` axis only.

Training is data-parallel across processes, one a card (torchrun, an
explicit gradient all_reduce in ``train/solver.py``, batch rows or corpus
shards per rank); conversion splits each dispatch's rows over the cards of
one process (``convert.Converter(devices=)``).
"""

from zerospeech_tts_tpu_torch.parallel.distributed import (  # noqa: F401
    barrier,
    destroy,
    initialize,
    is_primary,
    launch,
    local_device,
    rank,
    world,
)
from zerospeech_tts_tpu_torch.parallel.mesh import batch_slice, conversion_devices, parse_mesh  # noqa: F401
