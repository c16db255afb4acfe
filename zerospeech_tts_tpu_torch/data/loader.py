"""Host data loader of the PyTorch port (counterpart of
``zerospeech_tts_tpu/data/loader.py``, ``SegmentLoader``; ref dataloader.py).

Yields training batches of ``[B, seg_len, n_feat]`` f32 segments drawn from
a segment index (data/segments.py) over a corpus directory
(data/corpus.py): speaker ids, the stage-2 extras (``x_real``/``spk_real``
drawn from the target speakers' segments) and, with ``pairs``, the
same-utterance pair segment ``x2`` and its offset ``pair_dt``. The draws
and their order are the JAX loader's: ``idx``, then ``ridx``, from one
numpy ``Generator``, so the same index and seed give the same batches.

Utterances are read from the split's arena (``np.load(mmap_mode="r")``)
into an LRU cache, speaker-normalised there with the corpus statistics
when ``hps.speaker_norm`` (elementwise, so a segment of the normalised
utterance equals the normalised segment the JAX loader cuts); segments are
stacked into pinned host tensors and copied to
``device`` with ``non_blocking=True``. A background thread keeps
``prefetch`` batches ahead and hands any exception it meets to the
consumer. Speaker ids and ``pair_dt`` are int64, as the training step takes
them.

Data-parallel (``rank``/``world``): every rank makes the global batch's
index draws, in the same order from the same seed, and gathers and copies
only its rows (``parallel.mesh.batch_slice``, the rows JAX's ``P("data")``
puts on its device), so the ranks' batches together are the
single-process batch, row for row.
"""

from __future__ import annotations

import json
import queue
import threading
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.data.corpus import load_speaker_map, load_split
from zerospeech_tts_tpu_torch.data.device_dataset import check_speaker_ids
from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
from zerospeech_tts_tpu_torch.parallel.mesh import batch_slice
from zerospeech_tts_tpu_torch.tracing import span


class SegmentLoader:
    def __init__(
        self,
        corpus: str | Path,
        index_path: str | Path,
        hps: Hps,
        feat: str = "lin",
        split: str = "train",
        target_speakers: list[str] | None = None,
        device: str | torch.device = "cuda",
        seed: int = 0,
        cache_size: int = 1024,
        prefetch: int = 2,
        pairs: bool = False,  # also yield the same-utterance pair segment x2
        rank: int = 0,
        world: int = 1,
    ):
        self.pairs = pairs
        self.rows = batch_slice(rank, world, hps.batch_size)  # this rank's rows of each batch
        self.hps = hps
        self.feat = feat
        self.split = split
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.entries = json.loads(Path(index_path).read_text())
        if not self.entries:
            raise ValueError(f"empty segment index {index_path}")
        if pairs:
            # the pair objective floor-divides pair_dt by the downsample:
            # off-grid offsets would misalign the compared latents
            dts = np.array([e["t1"] - e["t0"] for e in self.entries])
            if (dts % hps.downsample).any():
                raise ValueError(
                    f"segment index {index_path} has pair offsets off the "
                    f"downsample={hps.downsample} grid: rebuild it with preprocess "
                    f"(make_segment_index pair_grid=hps.downsample), or pass "
                    f"pairs=False / --no-pairs"
                )
        self.speakers: dict[str, int] = load_speaker_map(corpus)
        check_speaker_ids(self.speakers, hps)
        self._arena, index = load_split(corpus, split, feat)
        if self._arena.shape[1] != hps.n_feat:
            raise ValueError(
                f"hps.n_feat={hps.n_feat} but corpus {feat!r} features have "
                f"{self._arena.shape[1]} bins: check --feat / hps"
            )
        self._where = {(spk, name): (s0, n) for spk, name, s0, n in
                       zip(index["speakers"], index["names"], index["starts"], index["lengths"])}
        self._cache: OrderedDict[tuple[str, str], np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        self.stats = SpeakerStats.load_corpus(corpus, feat) if hps.speaker_norm else None

        tgt = set(target_speakers or [])
        self._real_entries = [e for e in self.entries if e["speaker"] in tgt] or self.entries

        self._pin = self.device.type == "cuda"
        self._q: queue.Queue | None = None
        self._prefetch = prefetch
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def reseed(self, offset: int) -> None:
        """Re-key the sampling stream (call with the restored step on
        resume, so a resumed run continues with fresh batches instead of
        replaying the sequence from its start). With prefetch on, call it
        before iterating."""
        self.rng = np.random.default_rng(np.random.SeedSequence([self.hps.seed, int(offset)]))

    # ------------------------------------------------------------- access

    def _utt(self, spk: str, utt: str) -> np.ndarray:
        """The utterance's frames, speaker-normalised when the stats are on."""
        key = (spk, utt)
        arr = self._cache.get(key)
        if arr is not None:
            self._cache.move_to_end(key)
            return arr
        s0, n = self._where[key]
        arr = np.array(self._arena[s0 : s0 + n])
        if self.stats is not None:
            arr = self.stats.normalize(arr, spk).astype(np.float32)
        if len(self._cache) >= self._cache_size:
            self._cache.popitem(last=False)
        self._cache[key] = arr
        return arr

    def _segment(self, e: dict, t_key: str = "t0") -> np.ndarray:
        t0 = e[t_key]
        return self._utt(e["speaker"], e["utt"])[t0 : t0 + self.hps.seg_len]

    def _stack(self, segs: list[np.ndarray]) -> torch.Tensor:
        """[B, seg_len, F] f32 on the device, through a pinned host buffer."""
        buf = torch.empty((len(segs), *segs[0].shape), dtype=torch.float32, pin_memory=self._pin)
        np.stack(segs, out=buf.numpy())
        return buf.to(self.device, non_blocking=True)

    def _ids(self, ids: list[int]) -> torch.Tensor:
        """[B] int64 on the device; pinned too, so the copy does not wait
        for the training work queued on the stream."""
        t = torch.tensor(ids, dtype=torch.int64)
        return (t.pin_memory() if self._pin else t).to(self.device, non_blocking=True)

    def _assemble(self) -> dict:
        h = self.hps
        idx = self.rng.integers(0, len(self.entries), h.batch_size)
        ridx = self.rng.integers(0, len(self._real_entries), h.batch_size)
        picked = [self.entries[i] for i in idx[self.rows]]
        reals = [self._real_entries[i] for i in ridx[self.rows]]
        batch = {
            "x": self._stack([self._segment(e) for e in picked]),
            "spk": self._ids([self.speakers[e["speaker"]] for e in picked]),
            "x_real": self._stack([self._segment(e) for e in reals]),
            "spk_real": self._ids([self.speakers[e["speaker"]] for e in reals]),
        }
        if self.pairs:  # the same-utterance pair
            batch["x2"] = self._stack([self._segment(e, "t1") for e in picked])
            batch["pair_dt"] = self._ids([e["t1"] - e["t0"] for e in picked])
        return batch

    # ----------------------------------------------------------- iteration

    def _worker(self):
        while not self._stop.is_set():
            try:
                b = self._assemble()
            except Exception as e:  # handed to the consumer, which raises it
                b = e
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(b, Exception):
                return

    def __iter__(self):
        if self._prefetch > 0 and self._thread is None:
            self._q = queue.Queue(maxsize=self._prefetch)
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def __next__(self) -> dict:
        if self._thread is not None:
            with span("loader.wait"):
                b = self._q.get()
            if isinstance(b, Exception):
                raise b
            return b
        return self._assemble()

    def close(self):
        self._stop.set()
        if self._thread is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
            self._thread = None
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
