"""Training data on the card (counterpart of
``zerospeech_tts_tpu/data/device_dataset.py``, ``DeviceDataset``).

The train split's frames of one feature (``lin`` or ``mel``) go to the
device once as a flat arena ``[total_frames, n_feat]`` (f32, or bf16 to
halve its bytes; batches come out in f32 either way) with per-utterance
(start, length, speaker, real weight) tensors, speaker-normalised at load
when ``hps.speaker_norm``.
:meth:`DeviceDataset.sample_batch` draws a batch with a ``torch.Generator``
on the device, with no host traffic:

- utterances drawn in proportion to their number of valid segment
  positions (``length - seg_len + 1``), ``t0`` uniform over them;
- stage-2 reals drawn the same way, weighted by target speaker (all
  utterances when no target is given or none is in the corpus);
- the same-utterance pair ``x2`` at an offset uniform on the
  ``downsample`` grid within +-seg_len, clamped on-grid to the
  utterance's valid positions; ``pair_dt`` is that offset.

:class:`ShardedDeviceDataset` (JAX ``ShardedDeviceDataset``) is the arena
of one data-parallel rank: the non-target utterances go round-robin over
the ranks (in the JAX corpus's (speaker, utterance) name order), the
target-voice ones are on every rank with weight 1/world in the x draw (so
the global x distribution is the unsharded arena's), and each rank draws
``batch / world`` rows with its own generator.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.data.corpus import load_speaker_map, load_split
from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
from zerospeech_tts_tpu_torch.parallel.mesh import batch_slice


def check_speaker_ids(speakers: dict, hps: Hps) -> None:
    """Fail fast when corpus speaker ids exceed hps.n_speakers (an
    undersized embedding table or label space)."""
    if not speakers:
        return
    top = max(speakers, key=speakers.get)
    if speakers[top] >= hps.n_speakers:
        raise ValueError(
            f"corpus speaker ids reach {speakers[top]} ({top!r}) but "
            f"hps.n_speakers={hps.n_speakers}: raise n_speakers to at least {speakers[top] + 1}"
        )


def _gather(arena, starts, seg: int):
    """[B] start frames -> [B, seg, F] f32 segments of the arena."""
    idx = starts[:, None] + torch.arange(seg, device=arena.device)[None, :]
    return arena[idx].float()


def _load_utterances(corpus, hps: Hps, target_speakers, feat: str, by_name: bool = False):
    """(feature arrays, speaker ids, is-target flags) of the usable (>=
    seg_len + 1 frames) train utterances, normalised when
    ``hps.speaker_norm``; in the index's order, or with ``by_name`` in
    (speaker, utterance) name order (the JAX corpus's)."""
    if feat not in ("lin", "mel"):
        raise ValueError(f"feat must be lin or mel, got {feat!r}")
    speakers = load_speaker_map(corpus)
    check_speaker_ids(speakers, hps)
    stats = SpeakerStats.load_corpus(corpus, feat) if hps.speaker_norm else None
    arena, index = load_split(corpus, "train", feat)
    if arena.shape[1] != hps.n_feat:
        raise ValueError(
            f"hps.n_feat={hps.n_feat} but the corpus {feat!r} features have "
            f"{arena.shape[1]} bins: check --feat / hps"
        )
    order = range(len(index["names"]))
    if by_name:
        order = sorted(order, key=lambda i: (index["speakers"][i], index["names"][i]))
    tgt = set(target_speakers or [])
    chunks, spks, real = [], [], []
    for i in order:
        name, s0, n = index["speakers"][i], index["starts"][i], index["lengths"][i]
        if n < hps.seg_len + 1:
            continue
        arr = np.asarray(arena[s0 : s0 + n])
        if stats is not None:
            arr = stats.normalize(arr, name)
        chunks.append(arr.astype(np.float32))
        spks.append(speakers[name])
        real.append(name in tgt)
    if not chunks:
        raise ValueError(f"no usable utterances (>= seg_len + 1 frames) in {corpus}:train")
    return chunks, np.asarray(spks, np.int64), np.asarray(real, bool)


def _to_device(chunks, spks, real_w, device, dtype, *extra):
    """(arena, starts, lens, spk, real_w, *extra) tensors on ``device``:
    the utterances packed back to back, the arena in ``dtype``."""
    lens = np.asarray([c.shape[0] for c in chunks], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    dev = torch.device(device)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (as_t(np.concatenate(chunks)).to(dtype), as_t(starts), as_t(lens), as_t(spks),
            as_t(np.asarray(real_w, np.float32)), *(as_t(np.asarray(e, np.float32)) for e in extra))


class DeviceDataset:
    def __init__(self, arena, starts, lens, spk, real_w, hps: Hps):
        self.arena = arena    # [total_frames, F] f32 or bf16 on the device
        self.starts = starts  # [U] int64
        self.lens = lens      # [U] int64
        self.spk = spk        # [U] int64
        self.real_w = real_w  # [U] f32: stage-2 real weights (target speakers)
        self.hps = hps

    @classmethod
    def from_corpus(
        cls,
        corpus: str | Path,
        hps: Hps,
        target_speakers: list[str] | None = None,
        device: str | torch.device = "cuda",
        feat: str = "lin",
        dtype: torch.dtype = torch.float32,
    ) -> "DeviceDataset":
        """The train split's ``feat`` features (``lin`` or ``mel``) of a
        corpus directory (data/corpus.py), speaker-normalised with that
        feature's stats when ``hps.speaker_norm``, in an arena of ``dtype``
        (f32, or bf16: the normalised frames rounded once, at load)."""
        chunks, spks, real = _load_utterances(corpus, hps, target_speakers, feat)
        if not real.any():
            real[:] = True  # no targets known -> every speaker is "real"
        return cls(*_to_device(chunks, spks, real.astype(np.float32), device, dtype), hps)

    def _sample(self, weights, gen, batch: int):
        """(x [B, seg, F], spk [B], idx [B], t0 [B]): utterances drawn in
        proportion to weights x valid segment positions."""
        seg = self.hps.seg_len
        n_pos = (self.lens - seg + 1).clamp(min=0)
        idx = torch.multinomial(n_pos.float() * weights, batch, replacement=True, generator=gen)
        u = torch.rand(batch, generator=gen, device=self.arena.device)
        t0 = torch.minimum((u * n_pos[idx].float()).long(), n_pos[idx] - 1)
        return _gather(self.arena, self.starts[idx] + t0, seg), self.spk[idx], idx, t0

    def sample_batch(self, gen: torch.Generator, pairs: bool = True) -> dict:
        """{"x", "spk", "x_real", "spk_real"} (+ "x2", "pair_dt" when
        ``pairs``), hps.batch_size rows drawn with ``gen`` (a generator on
        the arena's device)."""
        return self._batch(gen, self.hps.batch_size, torch.ones_like(self.real_w), pairs)

    def _batch(self, gen, batch: int, x_w, pairs: bool) -> dict:
        """``batch`` rows: x (and its pair) drawn with base weights ``x_w``,
        the reals with ``real_w``."""
        h = self.hps
        x, spk, idx, t0 = self._sample(x_w, gen, batch)
        x_real, spk_real, _, _ = self._sample(self.real_w, gen, batch)
        out = {"x": x, "spk": spk, "x_real": x_real, "spk_real": spk_real}
        if not pairs:
            return out
        ds, seg = h.downsample, h.seg_len
        n_pos = (self.lens[idx] - seg + 1).clamp(min=1)
        steps = torch.randint(-(seg // ds), seg // ds + 1, (batch,), generator=gen,
                              device=self.arena.device)
        d = torch.clamp(ds * steps, min=-(t0 // ds) * ds, max=((n_pos - 1 - t0) // ds) * ds)
        out["x2"] = _gather(self.arena, self.starts[idx] + t0 + d, seg)
        out["pair_dt"] = d
        return out


class ShardedDeviceDataset(DeviceDataset):
    """One data-parallel rank's shard of the train split (module
    docstring); ``x_w`` [U] is each utterance's base weight in the x draw
    (1/world on the target-voice utterances every shard holds)."""

    def __init__(self, arena, starts, lens, spk, real_w, x_w, hps: Hps, rank: int, world: int):
        super().__init__(arena, starts, lens, spk, real_w, hps)
        self.x_w = x_w
        self.rank, self.world = rank, world

    @classmethod
    def from_corpus(
        cls,
        corpus: str | Path,
        hps: Hps,
        rank: int,
        world: int,
        target_speakers: list[str] | None = None,
        device: str | torch.device = "cuda",
        feat: str = "lin",
        dtype: torch.dtype = torch.float32,
    ) -> "ShardedDeviceDataset":
        """Rank ``rank``'s shard of ``world``, on ``device``: the target
        utterances and every world-th other one (all round-robin when every
        utterance is a target or none is named); raises when the shard
        would be empty."""
        chunks, spks, real = _load_utterances(corpus, hps, target_speakers, feat, by_name=True)
        real_idx = [i for i in range(len(chunks)) if real[i]]
        rest_idx = [i for i in range(len(chunks)) if not real[i]]
        if not rest_idx or not real_idx:  # no targets (all "real") or only targets: plain round-robin
            real_idx, rest_idx = [], list(range(len(chunks)))
            real[:] = True
        mine = real_idx + rest_idx[rank::world]
        if not mine:
            raise ValueError(f"corpus has fewer non-target utterances ({len(rest_idx)}) than "
                             f"mesh data={world} shards")
        x_w = np.ones(len(mine), np.float32)
        x_w[: len(real_idx)] = 1.0 / world
        return cls(*_to_device([chunks[i] for i in mine], spks[mine], real[mine], device, dtype, x_w),
                   hps, rank, world)

    def sample_batch(self, gen: torch.Generator, pairs: bool = True) -> dict:
        """This rank's rows of the global batch: hps.batch_size / world,
        drawn from its shard with ``gen`` (its own generator)."""
        sl = batch_slice(self.rank, self.world, self.hps.batch_size)
        return self._batch(gen, sl.stop - sl.start, self.x_w, pairs)
