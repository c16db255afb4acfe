"""Converter / discrete-unit dumper (port of ``zerospeech_tts_tpu/convert.py``;
ref convert.py --test / --test_single).

Per length bucket and batch chunk, straight from int16 PCM:
frontend (kernel) -> source z-norm -> encoder (GRU kernel) -> MBV bits ->
decoder for all targets folded into one batch (GRU kernel) -> target
denorm -> Griffin-Lim (kernel; from mel features after a pseudo-inverse
lift) -> de-emphasis -> PCM16. Units are written one latent frame per line
as space-separated 0/1 ints; wavs are 16 kHz PCM16 at
``<result>/<target_speaker>/<utt>.wav``.

Configurations, as the JAX Converter's: ``feat`` ``lin`` or ``mel`` (the
features the model was trained on); ``compute_dtype`` f32 (the
challenge-exact default) or bf16 for the decoder, and ``encoder_dtype``
(default: ``compute_dtype``) for the encoder, so ``--bf16 --enc-f32`` keeps
the exact encoder under a bf16 decoder. A bf16 module runs its
convolutions and dense layers in bf16 and its GRU through kernel 2's bf16
mode (f32 state); the frontend and Griffin-Lim stay f32 in every
configuration, and the decoder's output is f32 from the target denorm on.

Three sources: wavs (``convert_wavs_multi``, ``convert_wav_dir``), the
port's corpus directory of precomputed features (``convert_features_multi``,
``convert_corpus``; features cross to the device on the feature wire, bf16
unless ``wire="uint8"``, as the JAX package's), and units only, without
synthesis (``encode_units_from_wavs``, ``encode_units``, ``--units-only``;
always the f32 encoder, as the JAX package's units-only programs).
Buckets are uniform (``bucket_frames``) or fitted to the corpus lengths
(``fit_buckets``, ``plan_buckets``), and a ``frame_budget`` lets short
buckets take more rows a dispatch.

Several devices (``devices=[...]``, the JAX Converter's ``mesh`` over the
``data`` axis): the encoder and decoder are copied to each device, batch
rows are rounded up to a multiple of the device count, the bucket plan
stays the global one, and every dispatch's rows are split into one
contiguous slice a device, each launched on its device (frontend too)
before any is read back; results come back in row order, so every entry
point returns what the single-device Converter returns.

Two wires, as the JAX Converter's: ``pcm_wire="mulaw"`` (``--wire-mulaw``)
carries every PCM direction between host and device as 8-bit mu-law codes
(dsp/mulaw.py: wavs up, synthesised audio down; what the entry points
return and the files hold stays int16 PCM), and ``wire="uint8"``
(``--wire-uint8``) quantises each utterance's features to 256 levels over
its own [min, max] on the host and dequantises them on the device (the
features route; the wav routes have no feature wire).
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.dsp.mulaw import (
    mulaw_compress_device, mulaw_compress_host, mulaw_expand_device, mulaw_expand_host,
)
from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, save_wav, trim_silence
from zerospeech_tts_tpu_torch.models import Decoder, Encoder, discretize, unit_bits


def units_text(units: np.ndarray) -> str:
    """Challenge text format: one latent frame per line, bits
    space-separated (0/1 rows render as one vectorised byte interleave)."""
    u = np.asarray(units)
    if u.size == 0:
        return ""
    if u.ndim == 2 and u.dtype.kind in "iub" and ((u == 0) | (u == 1)).all():
        t, d = u.shape
        buf = np.empty((t, 2 * d), np.uint8)
        buf[:, 0::2] = u.astype(np.uint8) + ord("0")
        buf[:, 1::2] = ord(" ")
        buf[:, -1] = ord("\n")
        return buf.tobytes().decode("ascii")[:-1]
    return "\n".join(" ".join(str(int(v)) for v in row) for row in u)


def write_units(path: str | Path, units: np.ndarray) -> None:
    """Unit text file in the challenge format (see units_text)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(units_text(units) + "\n" if len(units) else "")


def read_units(path: str | Path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int32, ndmin=2)


def _round_rows(k: int, cap: int) -> int:
    """Smallest allowed batch-row count >= k, capped: powers of two plus
    their 1.5x points (1,2,3,4,6,8,12,16,...). Dummy rows run the whole
    path (the vocoder does not mask), so the 3*2^i points bound the
    round-up waste at 1/3."""
    k = min(int(k), int(cap))
    bs = 1
    while bs < k:
        bs *= 2
    three = 3 * (bs // 4)
    if three >= k:
        bs = three
    return min(bs, int(cap))


def _chunk_rows(k: int, cap: int) -> tuple[int, int]:
    """(executed batch rows, dispatch count) for ``k`` utterances chunked
    under a bucket cap: full chunks of ``cap`` rows plus one _round_rows
    tail chunk (Converter._chunk_batch's shapes)."""
    full, rem = divmod(int(k), int(cap))
    rows = full * cap
    n_disp = full
    if rem:
        rows += _round_rows(rem, cap)
        n_disp += 1
    return rows, n_disp


def plan_buckets(
    frame_lengths,
    max_buckets: int,
    quantum: int,
    min_pad: int = 4,
    target_overhead: float | None = None,
    cap_fn=None,
    dispatch_cost: float = 0.0,
) -> list[int]:
    """Pick <= max_buckets bucket edges (multiples of ``quantum``) that
    minimize total padded frames for the given utterance length multiset
    (copy of the JAX package's planner).

    ``min_pad``: an utterance sits at its edge exactly or has >= min_pad
    pad frames (Converter._MIN_PAD), so the executed plan never falls back
    to an out-of-plan uniform bucket.

    ``target_overhead``: return the SMALLEST number of edges whose planned
    padding overhead (padded/true - 1) is <= target, or the best plan
    within ``max_buckets`` when no k meets it.

    ``cap_fn`` (bucket frames -> batch-row cap) switches the objective from
    padded frames to EXECUTED rows*frames: dummy rows run the whole path
    (the vocoder does not mask), so each candidate bucket is charged its
    chunked cost (full cap-row chunks + one rounded tail) plus
    ``dispatch_cost`` frame-rows a dispatch; more edges can then hurt and
    every k is searched.

    Exact DP (1-D clustering) over the distinct quantized lengths:
    dp[j][k] = least cost covering groups 1..j with k edges, edge k at
    group j's value. O(m^2 * max_buckets) for m distinct lengths.
    """
    if int(max_buckets) < 1:
        raise ValueError(f"adaptive bucket count must be >= 1, got {max_buckets}")
    ts = np.asarray(frame_lengths, np.int64)
    if ts.size == 0:
        return []
    q = int(quantum)
    quant = -(-ts // q) * q  # ceil to quantum
    while True:  # bump 1..min_pad-1 pads up a quantum (loops only if q < min_pad)
        short = (quant > ts) & (quant - ts < int(min_pad))
        if not short.any():
            break
        quant = np.where(short, quant + q, quant)
    vals, inv = np.unique(quant, return_inverse=True)
    m = len(vals)
    cnt = np.bincount(inv, minlength=m).astype(np.int64)
    tsum = np.bincount(inv, weights=ts.astype(np.float64), minlength=m)
    ccum = np.concatenate([[0], np.cumsum(cnt)])
    scum = np.concatenate([[0.0], np.cumsum(tsum)])
    k_max = min(int(max_buckets), m)
    INF = float("inf")
    dp = np.full((m + 1, k_max + 1), INF)
    prev = np.zeros((m + 1, k_max + 1), np.int64)
    dp[0, 0] = 0.0
    caps = None
    if cap_fn is not None:
        caps = [max(1, int(cap_fn(int(v)))) for v in vals]
    for k in range(1, k_max + 1):
        for j in range(1, m + 1):
            # groups i+1..j all pad to vals[j-1]
            best, arg = INF, 0
            for i in range(k - 1, j):
                if dp[i, k - 1] == INF:
                    continue
                count = ccum[j] - ccum[i]
                if caps is None:
                    seg = vals[j - 1] * count - (scum[j] - scum[i])
                else:
                    rows, n_disp = _chunk_rows(count, caps[j - 1])
                    seg = (rows * vals[j - 1] - (scum[j] - scum[i])
                           + dispatch_cost * n_disp)
                c = dp[i, k - 1] + seg
                if c < best:
                    best, arg = c, i
            dp[j, k] = best
            prev[j, k] = arg
    if target_overhead is not None:
        total_true = float(scum[m])
        k_best = 0
        for k in range(1, k_max + 1):
            if dp[m, k] <= target_overhead * total_true:
                k_best = k
                break
        if not k_best:  # target unreachable within max_buckets: best effort
            k_best = int(np.argmin(dp[m, 1:])) + 1
    else:
        # frames mode: fewer edges never help; executed mode: they can
        k_best = int(np.argmin(dp[m, 1:])) + 1
    edges, j = [], m
    for k in range(k_best, 0, -1):
        edges.append(int(vals[j - 1]))
        j = int(prev[j, k])
    return sorted(edges)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype) and d in _DTYPES.values():
        return d
    if d in _DTYPES:
        return _DTYPES[d]
    raise ValueError(f"compute dtype must be float32 or bfloat16, got {d!r}")


def uint8_wire(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A padded f32 feature batch [B, T, F] -> (uint8 codes, lo [B], scale
    [B]): each row over its own [min, max], zero padding included, scale =
    max(hi - lo, 1e-6) / 255, codes rint'd and clipped to 0..255 (the JAX
    Converter's ``_wire_batch``, in the same order of in-place passes).
    The device reads x = q * scale + lo."""
    lo = x.min(axis=(1, 2)).astype(np.float32)
    hi = x.max(axis=(1, 2)).astype(np.float32)
    scale = np.maximum(hi - lo, 1e-6) / 255.0
    q = x - lo[:, None, None]
    np.multiply(q, (1.0 / scale)[:, None, None], out=q)
    np.rint(q, out=q)
    np.clip(q, 0.0, 255.0, out=q)
    return q.astype(np.uint8), lo, scale


class Converter:
    """Encoder + decoder on ``device``, converting PCM or feature batches
    per padded length bucket. ``enc_state``/``dec_state`` are the port's
    state dicts (``params.from_flax``). On ``device="cuda"`` (the default)
    it runs the hand-written kernels and never falls back to the CPU;
    ``device="cpu"`` runs their plain versions. ``feat``, ``compute_dtype``
    and ``encoder_dtype`` as in the JAX Converter (module docstring).

    ``frame_budget`` (rows*frames a dispatch): short buckets take more
    utterances a dispatch (_bucket_cap: the largest allowed row count
    within the budget, never below batch_size, at most 128 rows). None
    keeps the flat batch_size cap.

    ``check_numerics``: raise FloatingPointError at the first non-finite
    encoder logit of a true frame (one wait for the device a dispatch).

    ``wire`` (features, host to device): ``"bf16"`` or ``"uint8"`` (per
    utterance min/max codes, dequantised on the device in the compute
    dtype, in f32 for units only). ``pcm_wire`` (PCM, both directions):
    ``"int16"`` or ``"mulaw"`` (8-bit codes; the entry points still return
    int16). Either names the JAX Converter's option of the same name.

    ``devices``: local devices to split each dispatch's rows over (module
    docstring); None means ``[device]``. A device may repeat (the split on
    one card, or on the CPU); the model is copied to each distinct device
    here, so later edits of ``encoder``/``decoder`` (``devices[0]``'s)
    reach that device only."""

    def __init__(
        self,
        hps: Hps,
        acfg: AudioConfig,
        enc_state: dict,
        dec_state: dict,
        gl_iters: int | None = None,
        batch_size: int = 8,
        bucket_frames: int = 64,
        frame_budget: int | None = None,
        stats=None,  # SpeakerStats when hps.speaker_norm (z-norm in/out)
        device: str | torch.device = "cuda",
        feat: str = "lin",  # which features the model was trained on (lin|mel)
        compute_dtype="float32",  # the decoder's dtype: float32 | bfloat16
        encoder_dtype=None,  # the encoder's: None -> compute_dtype
        check_numerics: bool = False,
        devices=None,  # split every dispatch's rows over these devices
        wire: str = "bf16",  # features, host to device: bf16 | uint8
        pcm_wire: str = "int16",  # PCM, both directions: int16 | mulaw
    ):
        if feat not in ("lin", "mel"):
            raise ValueError(f"feat must be lin or mel, got {feat!r}")
        if wire not in ("bf16", "uint8"):
            raise ValueError(f"wire must be bf16 or uint8, got {wire!r}")
        if pcm_wire not in ("int16", "mulaw"):
            raise ValueError(f"pcm_wire must be int16 or mulaw, got {pcm_wire!r}")
        assert bucket_frames % hps.downsample == 0
        self.feat, self.wire, self.pcm_wire = feat, wire, pcm_wire
        self.compute_dtype = _as_dtype(compute_dtype)
        self.encoder_dtype = _as_dtype(encoder_dtype) if encoder_dtype else self.compute_dtype
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices) and not torch.cuda.is_available():
            raise RuntimeError(f"devices {self.devices}: no CUDA device is visible")
        self.hps, self.acfg, self.stats = hps, acfg, stats
        self.check_numerics = check_numerics
        self.gl_iters = gl_iters if gl_iters is not None else acfg.gl_iters
        n_dev = len(self.devices)
        self.batch_size = -(-batch_size // n_dev) * n_dev  # whole rows on every device
        self.bucket_frames = bucket_frames
        self.frame_budget = frame_budget
        self.bucket_edges: list[int] | None = None  # set by fit_buckets()
        self.encoder = Encoder(hps)
        self.decoder = Decoder(hps)
        self.encoder.load_state_dict(enc_state)
        self.decoder.load_state_dict(dec_state)
        self.encoder.to(self.device).eval().requires_grad_(False)  # f32: units-only
        self.decoder.to(self.device, self.compute_dtype).eval().requires_grad_(False)
        # the conversion's encoder: the f32 one, or a copy cast to encoder_dtype
        self.conv_encoder = (self.encoder if self.encoder_dtype == torch.float32
                             else copy.deepcopy(self.encoder).to(self.encoder_dtype))
        # device -> (encoder, conversion encoder, decoder) on it
        self._models = {self.device: (self.encoder, self.conv_encoder, self.decoder)}
        for d in self.devices[1:]:
            if d not in self._models:
                enc = copy.deepcopy(self.encoder).to(d)
                conv_enc = enc if self.conv_encoder is self.encoder else copy.deepcopy(self.conv_encoder).to(d)
                self._models[d] = (enc, conv_enc, copy.deepcopy(self.decoder).to(d))

    # ------------------------------------------------------------- buckets

    # Minimum nonzero bucket padding, in input frames. The encoder's widest
    # conv (bank kernel 8) reads 4 rows past the true boundary; with >= 4
    # pad rows those reads land in the mirror-filled region, which makes
    # padded encoding equal exact-length encoding (models/encoder.py).
    _MIN_PAD = 4

    def _bucket_of(self, t: int) -> int:
        """Padded frame count for a true frame count ``t``: the smallest
        fitted edge >= t when fit_buckets() ran, else ceil to
        bucket_frames; an edge leaving 1..3 pad frames is passed over (a
        uniform bucket is bumped one up), so padding is 0 or >= _MIN_PAD."""
        if self.bucket_edges:
            edges = self.bucket_edges
            j = int(np.searchsorted(np.asarray(edges), t))
            while j < len(edges):
                if edges[j] == t or edges[j] - t >= self._MIN_PAD:
                    return edges[j]
                j += 1
            # longer than anything fitted: fall back to uniform quantization
        tb = -(-t // self.bucket_frames) * self.bucket_frames
        if 0 < tb - t < self._MIN_PAD:
            tb += self.bucket_frames
        return tb

    def fit_buckets(
        self, frame_lengths, max_buckets: int, target_overhead: float | None = None,
        cost_model: str = "frames", dispatch_cost_frames: float = 0.0,
    ) -> list[int]:
        """Fit at most ``max_buckets`` edges (multiples of bucket_frames) to
        the utterances' true frame counts (plan_buckets). ``cost_model``:
        ``"frames"`` minimizes padded frames; ``"executed"`` the rows*frames
        the dispatches run under this Converter's chunking (tail rounding,
        frame-budget caps) plus ``dispatch_cost_frames`` frame-rows a
        dispatch."""
        if cost_model not in ("frames", "executed"):
            raise ValueError(f"cost_model must be frames|executed, got {cost_model!r}")
        self.bucket_edges = plan_buckets(
            frame_lengths, max_buckets, self.bucket_frames,
            min_pad=self._MIN_PAD, target_overhead=target_overhead,
            cap_fn=self._bucket_cap if cost_model == "executed" else None,
            dispatch_cost=dispatch_cost_frames,
        )
        return self.bucket_edges

    def _bucket_cap(self, tb: int) -> int:
        """Batch cap for a bucket of ``tb`` frames: batch_size, or with a
        frame_budget the largest allowed row count (_round_rows' set) whose
        rows*frames stays within it (never below batch_size, <= 128)."""
        if not self.frame_budget:
            return self.batch_size
        cap = 1
        for s in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128):
            if s * tb <= self.frame_budget:
                cap = s
        return max(cap, self.batch_size)

    def _chunk_batch(self, k: int, cap: int | None = None) -> int:
        """Batch rows for a chunk of ``k`` utterances: the smallest allowed
        row count >= k (_round_rows), capped at the bucket's cap, rounded up
        to a multiple of the device count."""
        n_dev = len(self.devices)
        return -(-_round_rows(k, cap or self.batch_size) // n_dev) * n_dev

    def _slices(self, rows: int):
        """(device, row slice) of each device's contiguous share of a
        ``rows``-row dispatch."""
        b = rows // len(self.devices)
        return [(d, slice(i * b, (i + 1) * b)) for i, d in enumerate(self.devices)]

    def _pad_frames(self, feats: np.ndarray) -> np.ndarray:
        t = feats.shape[0]
        tb = self._bucket_of(t)
        if tb > t:
            feats = np.pad(feats, ((0, tb - t), (0, 0)))
        return feats

    def _dispatches(self, frames: list[int], sizes: list[int]):
        """(bucket frames, utterance indices, batch rows) of each dispatch:
        utterances longest ``sizes`` first (stable), grouped by bucket and
        chunked by the bucket's cap."""
        buckets: dict[int, list[int]] = {}
        for i in np.argsort([-s for s in sizes], kind="stable"):
            buckets.setdefault(self._bucket_of(int(frames[i])), []).append(int(i))
        for tb, idxs in buckets.items():
            cap = self._bucket_cap(tb)
            for c0 in range(0, len(idxs), cap):
                chunk = idxs[c0 : c0 + cap]
                yield tb, chunk, self._chunk_batch(len(chunk), cap)

    # ---------------------------------------------------------------- core

    def _convert_core(self, dev, x, spk, tgt_mean, tgt_std, tlens):
        """Normalised features x [B, T, F] on ``dev`` (one of the devices)
        -> (units [B, T/ds, emb] int32, PCM [n_tgt, B, (T-1)*hop]: int16, or
        uint8 mu-law codes on the mu-law wire) there. ``tlens`` ([B] true
        frame counts) drives the length-masked encoder/decoder so bucket
        padding never changes the true frames' units or audio."""
        hps, acfg = self.hps, self.acfg
        _, conv_encoder, decoder = self._models[dev]
        zlens = (tlens + hps.downsample - 1) // hps.downsample
        logits = conv_encoder(x, lengths=tlens).float()
        self._check_logits(logits, tlens)
        units = unit_bits(logits, hps.enc_mode)
        z = (
            discretize(logits, hps.enc_mode, hps.gumbel_temp, None)
            if hps.enc_mode == "continues"
            else units.to(torch.float32)
        )  # the decoder casts it to its dtype
        # Cross-target batched decode: fold the target axis into the batch
        # (batch-major, targets minor) so the decoder and its frame-rate GRU
        # run once at B * n_tgt rows, and the vocoder once over all of them.
        n_tgt, bsz = spk.shape
        z_all = z[:, None].expand(bsz, n_tgt, *z.shape[1:]).reshape(bsz * n_tgt, *z.shape[1:])
        spk_flat = spk.T.reshape(-1)
        xh = decoder(z_all, spk_flat, lengths=zlens.repeat_interleave(n_tgt)).float()
        mean_all = tgt_mean[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        std_all = tgt_std[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        xh = torch.clamp(xh * std_all + mean_all, 0.0, 1.0)
        vocoder = dsp_audio.spectrogram2wav if self.feat == "lin" else dsp_audio.melspectrogram2wav
        wav = vocoder(xh, acfg, n_iters=self.gl_iters)  # [B*n_tgt, n]
        if self.pcm_wire == "mulaw":  # the 8-bit companded down-wire
            pcm = mulaw_compress_device(torch.clamp(wav, -1.0, 1.0))
        else:
            pcm = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
        return units, pcm.reshape(bsz, n_tgt, -1).transpose(0, 1)

    def _encode(self, dev, x, tlens):
        """Normalised features [B, T, F] on ``dev`` -> units [B, T/ds, emb]
        int32, from the f32 encoder in every configuration (the JAX
        package's units-only programs run the uncast parameters)."""
        logits = self._models[dev][0](x, lengths=tlens)
        self._check_logits(logits, tlens)
        return unit_bits(logits, self.hps.enc_mode)

    def _check_logits(self, logits, tlens) -> None:
        """With check_numerics: raise at a non-finite logit of a true
        latent frame (frames past ceil(tlens / downsample) are bucket
        padding)."""
        if not self.check_numerics:
            return
        zlens = (tlens.to(logits.device) + self.hps.downsample - 1) // self.hps.downsample
        true = torch.arange(logits.shape[1], device=logits.device)[None, :] < zlens[:, None]
        bad = ~torch.isfinite(logits).reshape(*logits.shape[:2], -1).all(dim=-1) & true
        if bool(bad.any()):
            rows = sorted({int(r) for r in bad.nonzero()[:, 0].tolist()})
            raise FloatingPointError(f"--check-numerics: conversion: non-finite encoder logits in batch "
                                     f"rows {rows} of a [{logits.shape[0]}, {logits.shape[1]}] dispatch")

    def _wav_features(self, pcm, src_mean, src_std, slens):
        """Wire PCM [B, n_samp] (int16, or mu-law codes) -> frontend ->
        source z-norm: (features [B, T, F], true frame counts [B]).
        ``slens`` ([B] true sample counts) gives exact tail reflection in
        the frontend."""
        if self.pcm_wire == "mulaw":
            y = mulaw_expand_device(pcm)
        else:
            y = pcm.to(torch.float32) * (1.0 / 32768.0)  # load_wav convention
        mel, mag = dsp_audio.wav_to_features(y, self.acfg, length=slens)
        x = ((mag if self.feat == "lin" else mel) - src_mean[:, None, :]) / src_std[:, None, :]
        return x, 1 + slens // self.acfg.hop_length

    def _src_stats(self, n: int, src_speakers):
        """Source z-norm [n, F] mean/std: the speakers' statistics
        ('__global__' when not given), or identity without stats."""
        if self.stats is None:
            return (np.zeros((n, self.hps.n_feat), np.float32),
                    np.ones((n, self.hps.n_feat), np.float32))
        return self.stats.arrays_for(src_speakers or ["__global__"] * n)

    def _tgt_stats(self, spk_ids, tgt_names):
        """Target denorm [n_tgt, F] mean/std on each device."""
        if self.stats is None:
            m = np.zeros((len(spk_ids), self.hps.n_feat), np.float32)
            s = np.ones((len(spk_ids), self.hps.n_feat), np.float32)
        else:
            m, s = self.stats.arrays_for(tgt_names)
        return {d: (torch.from_numpy(m).to(d), torch.from_numpy(s).to(d)) for d in self._models}

    def _pcm_features(self, dev, pcm, sm, ss, sl):
        """Host rows of a PCM dispatch -> (features, true frame counts) on
        ``dev`` (the frontend runs there)."""
        return self._wav_features(*(torch.from_numpy(a).to(dev) for a in (pcm, sm, ss, sl)))

    def _wire_features(self, dev, x, tl, lo=None, scale=None, dtype=torch.float32):
        """Host rows of a feature dispatch -> (features, true frame counts)
        on ``dev``. On the bf16 wire ``x`` crosses in bf16 and is read back
        in f32; on the uint8 wire ``x`` holds the codes, dequantised there
        in ``dtype`` as q * scale + lo."""
        tl = torch.from_numpy(tl).to(dev)
        if lo is None:
            return torch.from_numpy(x).to(torch.bfloat16).to(dev).to(torch.float32), tl
        lo, scale = (torch.from_numpy(a).to(dev).to(dtype)[:, None, None] for a in (lo, scale))
        return torch.from_numpy(x).to(dev).to(dtype) * scale + lo, tl

    def _pcm_chunks(self, wavs, s_mean, s_std):
        """Per dispatch of the trimmed float ``wavs``: (utterance indices,
        batch rows, host arrays [rows, ...], the function that takes a
        device and rows of them to device features [rows, tb, F] and true
        frame counts). Dummy rows are silent and act full-length."""
        acfg, hps = self.acfg, self.hps
        frames = [dsp_audio.n_frames_for(len(w), acfg) for w in wavs]
        mulaw = self.pcm_wire == "mulaw"
        for tb, chunk, bs_c in self._dispatches(frames, [len(w) for w in wavs]):
            n_samp = tb * acfg.hop_length - 1  # longest signal with tb frames
            # mu-law silence is code 128 (code 0 would be full scale negative)
            pcm = np.full((bs_c, n_samp), 128, np.uint8) if mulaw else np.zeros((bs_c, n_samp), np.int16)
            sm = np.zeros((bs_c, hps.n_feat), np.float32)
            ss = np.ones((bs_c, hps.n_feat), np.float32)
            sl = np.full(bs_c, n_samp, np.int64)
            for j, i in enumerate(chunk):
                w = np.clip(np.rint(wavs[i] * 32768.0), -32768, 32767).astype(np.int16)
                pcm[j, : len(w)] = mulaw_compress_host(w) if mulaw else w
                sm[j], ss[j] = s_mean[i], s_std[i]
                sl[j] = len(w)
            yield chunk, bs_c, (pcm, sm, ss, sl), self._pcm_features

    def _feature_chunks(self, feats_list, dtype=torch.float32):
        """Per dispatch of normalised [T_i, F] features: as _pcm_chunks,
        the features crossing on the Converter's wire (uint8: the codes,
        their lo and scale, dequantised in ``dtype``); dummy rows are zeros
        at full length."""
        frames = [f.shape[0] for f in feats_list]
        to_device = lambda dev, *a: self._wire_features(dev, *a, dtype=dtype)  # noqa: E731
        for tb, chunk, bs_c in self._dispatches(frames, frames):
            x = np.zeros((bs_c, tb, self.hps.n_feat), np.float32)
            tl = np.full(bs_c, tb, np.int64)
            for j, i in enumerate(chunk):
                x[j] = self._pad_frames(feats_list[i])
                tl[j] = frames[i]
            if self.wire == "uint8":
                q, lo, scale = uint8_wire(x)
                yield chunk, bs_c, (q, tl, lo, scale), to_device
            else:
                yield chunk, bs_c, (x, tl), to_device

    def _launch(self, chunks, core):
        """For each dispatch, ``core(dev, x, tlens)`` on every device's
        slice of its rows, all launched before any is read back: [(utterance
        indices, [each slice's outputs])]."""
        inflight = []
        for chunk, bs_c, arrays, to_device in chunks:
            parts = []
            for dev, rows in self._slices(bs_c):
                x, tlens = to_device(dev, *(a[rows] for a in arrays))
                parts.append(core(dev, x, tlens))
            inflight.append((chunk, parts))
        return inflight

    def _normalized(self, feats_list, src_speakers):
        """Features z-scored with each source speaker's statistics."""
        if self.stats is None:
            return [np.asarray(f, np.float32) for f in feats_list]
        return [self.stats.normalize(f, s) for f, s in zip(feats_list, src_speakers)]

    def _run_conversion(self, chunks, n, spk_ids, tgt_names, t_true):
        """Launch the whole path for every chunk first, then read back:
        (units_list, wavs_per_target) trimmed to each utterance's
        ``t_true`` frames, mu-law codes expanded to int16 on the host."""
        if self.stats is not None and tgt_names is None:
            raise ValueError(
                "speaker_norm is on (Converter has stats) but tgt_names was not given — "
                "conversion would denormalize with the WRONG (global) statistics. Pass "
                "per-target names, or build the Converter with stats=None to opt out."
            )
        t_stats = self._tgt_stats(spk_ids, tgt_names)
        spk_arr = np.asarray(spk_ids, np.int64)[:, None]

        def core(dev, x, tlens):
            spk = torch.from_numpy(np.tile(spk_arr, (1, x.shape[0]))).to(dev)
            return self._convert_core(dev, x, spk, *t_stats[dev], tlens)

        inflight = self._launch(chunks, core)
        ds, hop = self.hps.downsample, self.acfg.hop_length
        units_out: list = [None] * n
        wavs_out: list[list] = [[None] * n for _ in spk_ids]
        for chunk, parts in inflight:  # row j is row j % b of slice j // b: no concatenating copy
            units = [u.cpu().numpy() for u, _ in parts]
            pcm = [p.cpu().numpy() for _, p in parts]  # each [n_tgt, b, n]
            b = units[0].shape[0]
            for j, i in enumerate(chunk):
                q, r = divmod(j, b)
                units_out[i] = units[q][r][: -(-t_true[i] // ds)].astype(np.int32)
                for k in range(len(spk_ids)):
                    row = pcm[q][k, r][: max(t_true[i] - 1, 1) * hop]
                    wavs_out[k][i] = mulaw_expand_host(row) if self.pcm_wire == "mulaw" else row
        return units_out, wavs_out

    def _run_encoding(self, chunks, n, t_true):
        inflight = self._launch(chunks, self._encode)
        ds = self.hps.downsample
        out: list = [None] * n
        for chunk, parts in inflight:
            units = [u.cpu().numpy() for u in parts]
            b = units[0].shape[0]
            for j, i in enumerate(chunk):
                q, r = divmod(j, b)
                out[i] = units[q][r][: -(-t_true[i] // ds)].astype(np.int32)
        return out

    def _trimmed(self, wavs, trim: bool):
        wavs = [np.asarray(w, np.float32) for w in wavs]
        return [trim_silence(w, self.acfg.top_db) for w in wavs] if trim else wavs

    # ------------------------------------------------------------- entries

    @torch.inference_mode()
    def convert_wavs_multi(
        self,
        wavs: list[np.ndarray],
        spk_ids: list[int],
        tgt_names: list[str] | None = None,
        src_speakers: list[str] | None = None,
        trim: bool = True,
    ):
        """Batch voice conversion straight from float wavs for several
        targets: trim on the host, then one pass of the whole path per
        bucket chunk. Returns (units_list, wavs_per_target): units_list[i]
        is utterance i's {0,1} int32 [ceil(t/ds), emb] array,
        wavs_per_target[k][i] its int16 PCM for target k. With speaker_norm
        on, sources default to the '__global__' statistics."""
        wavs = self._trimmed(wavs, trim)
        s_mean, s_std = self._src_stats(len(wavs), src_speakers)
        t_true = [dsp_audio.n_frames_for(len(w), self.acfg) for w in wavs]
        return self._run_conversion(self._pcm_chunks(wavs, s_mean, s_std), len(wavs), spk_ids,
                                    tgt_names, t_true)

    @torch.inference_mode()
    def encode_units_from_wavs(
        self,
        wavs: list[np.ndarray],
        src_speakers: list[str] | None = None,
        trim: bool = True,
    ) -> list[np.ndarray]:
        """Units straight from wavs, no synthesis (ref enc_only x --test,
        the bitrate-only submission): frontend -> source z-norm ->
        encoder -> MBV bits, bucketed and chunked as convert_wavs_multi,
        so its units are those of the full conversion. Sources default to
        the '__global__' statistics."""
        wavs = self._trimmed(wavs, trim)
        s_mean, s_std = self._src_stats(len(wavs), src_speakers)
        t_true = [dsp_audio.n_frames_for(len(w), self.acfg) for w in wavs]
        return self._run_encoding(self._pcm_chunks(wavs, s_mean, s_std), len(wavs), t_true)

    @torch.inference_mode()
    def encode_units(self, feats_list: list[np.ndarray], src_speakers=None) -> list[np.ndarray]:
        """Units for [T_i, n_feat] features without synthesis (ref
        enc_only). Raises when stats are on and ``src_speakers`` is
        missing. Chunks follow _chunk_batch, as convert_features_multi's
        do; the JAX package pads every chunk here to batch_size, which
        changes no unit (a row's units do not depend on the other rows)."""
        if self.stats is not None and src_speakers is None:
            raise ValueError(
                "speaker_norm is on (Converter has stats) but src_speakers was not given — "
                "units would be computed from features normalized with the WRONG (global) "
                "statistics. Pass the source speaker per utterance, or build the Converter "
                "with stats=None to opt out."
            )
        feats_list = self._normalized(feats_list, src_speakers)
        t_true = [f.shape[0] for f in feats_list]
        return self._run_encoding(self._feature_chunks(feats_list), len(feats_list), t_true)

    @torch.inference_mode()
    def convert_features_multi(
        self,
        feats_list: list[np.ndarray],
        spk_ids: list[int],
        tgt_names: list[str] | None = None,
        src_speakers: list[str] | None = None,
    ):
        """Convert [T_i, n_feat] features (the Converter's ``feat``) for
        several targets in one pass (same returns as convert_wavs_multi).
        With stats on, both ``src_speakers`` and ``tgt_names`` are required."""
        if self.stats is not None and (src_speakers is None or tgt_names is None):
            raise ValueError(
                "speaker_norm is on (Converter has stats) but "
                f"{'src_speakers' if src_speakers is None else 'tgt_names'} was not given — "
                "conversion would (de)normalize with the WRONG (global) statistics. Pass "
                "per-utterance source speakers and per-target names, or build the Converter "
                "with stats=None to opt out."
            )
        feats_list = self._normalized(feats_list, src_speakers)
        t_true = [f.shape[0] for f in feats_list]
        return self._run_conversion(self._feature_chunks(feats_list, self.compute_dtype), len(feats_list),
                                    spk_ids, tgt_names, t_true)

    def convert_features(self, feats_list: list[np.ndarray], spk_id: int):
        """Single-target convenience wrapper: [(units_i, wav_i)]."""
        units, wavs = self.convert_features_multi(feats_list, [spk_id])
        return list(zip(units, wavs[0]))

    def convert_wav(self, wav: np.ndarray, spk_id: int, trim: bool = True, tgt_name=None):
        """Single-utterance conversion (ref --test_single); the source is
        z-scored with the global statistics when speaker_norm is on."""
        if self.stats is not None and tgt_name is None:
            raise ValueError(
                "speaker_norm is on: convert_wav needs tgt_name to denormalize "
                "with the target speaker's statistics"
            )
        units, wavs = self.convert_wavs_multi(
            [wav], [spk_id], tgt_names=[tgt_name] if self.stats is not None else None, trim=trim
        )
        return units[0], wavs[0][0]


def _bucket_stats(converter: Converter, true_frames) -> dict:
    """The bucket plan in effect for these utterance lengths: its edges,
    padding overhead (padded/true - 1), executed overhead (rows*frames of
    the dispatches, tail rounding included, /true - 1) and dispatch count."""
    padded = [converter._bucket_of(t) for t in true_frames]
    by_bucket: dict[int, int] = {}
    for tb in padded:
        by_bucket[tb] = by_bucket.get(tb, 0) + 1
    rows_frames, n_disp = 0, 0
    for tb, count in by_bucket.items():
        rows, nd = _chunk_rows(count, converter._bucket_cap(tb))
        rows_frames += rows * tb
        n_disp += nd
    true_total = max(sum(true_frames), 1)
    return {
        "bucket_edges": sorted(by_bucket),
        "padding_overhead": round(sum(padded) / true_total - 1, 4),
        "executed_overhead": round(rows_frames / true_total - 1, 4),
        "n_dispatches": n_disp,
    }


def _convert_planned(
    converter: Converter,
    names: list[str],
    true_frames: list[int],
    result_dir: str | Path,
    target_speakers: dict[str, int],
    encode,
    convert,
    sr: int,
    units_only: bool,
    progress,
    adaptive_buckets: int | None,
    bucket_overhead_target: float | None,
    bucket_cost_model: str,
    dispatch_cost_frames: float,
) -> dict:
    """The shared body of convert_corpus and convert_wav_dir: fit
    ``adaptive_buckets`` edges to ``true_frames`` for this call only
    (``bucket_cost_model`` and ``dispatch_cost_frames`` as fit_buckets'), run
    ``encode()`` (units only) or ``convert(spk_ids, tgt_names)``, write
    ``<result>/units/<utt>.txt`` per utterance and, unless units only,
    ``<result>/<target>/<utt>.wav`` per target. Returns the counts and the
    plan's _bucket_stats."""
    result_dir = Path(result_dir)
    tgt_names = list(target_speakers)
    prev_edges = converter.bucket_edges  # fitted edges are scoped to this corpus
    try:
        if adaptive_buckets:
            converter.fit_buckets(true_frames, adaptive_buckets, target_overhead=bucket_overhead_target,
                                  cost_model=bucket_cost_model, dispatch_cost_frames=dispatch_cost_frames)
        bucket_stats = _bucket_stats(converter, true_frames)
        if units_only:
            units_list, wavs_per_tgt = encode(), ()
        else:
            units_list, wavs_per_tgt = convert([target_speakers[t] for t in tgt_names], tgt_names)
    finally:
        converter.bucket_edges = prev_edges
    for utt, units in zip(names, units_list):
        write_units(result_dir / "units" / f"{utt}.txt", units)
    n_wav = 0
    for tgt_name, wavs in zip(tgt_names, wavs_per_tgt):
        for utt, wav in zip(names, wavs):
            save_wav(result_dir / tgt_name / f"{utt}.wav", wav, sr)
            n_wav += 1
            if progress:
                progress(tgt_name, utt)
    return {"n_utterances": len(names), "n_wavs": n_wav, "result_dir": str(result_dir),
            **bucket_stats}


def load_corpus_split(dataset_path: str | Path, split: str = "test", limit: int | None = None,
                      feat: str = "lin"):
    """(``feat`` features, utterance names, speakers) of a corpus split in
    (speaker, utterance) name order, the order in which the JAX package
    walks its h5 groups, so ``limit`` picks the same utterances."""
    from zerospeech_tts_tpu_torch.data.corpus import load_split

    arena, index = load_split(dataset_path, split, feat)
    order = sorted(range(len(index["names"])), key=lambda i: (index["speakers"][i], index["names"][i]))
    if limit:
        order = order[:limit]
    feats = [np.asarray(arena[index["starts"][i] : index["starts"][i] + index["lengths"][i]])
             for i in order]
    return feats, [index["names"][i] for i in order], [index["speakers"][i] for i in order]


def convert_corpus(
    converter: Converter,
    dataset_path: str | Path,
    result_dir: str | Path,
    target_speakers: dict[str, int],
    split: str = "test",
    sr: int = 16000,
    limit: int | None = None,
    units_only: bool = False,
    progress=None,
    adaptive_buckets: int | None = None,
    bucket_overhead_target: float | None = None,
    bucket_cost_model: str = "frames",
    dispatch_cost_frames: float = 0.0,
) -> dict:
    """Corpus conversion and unit extraction from the features of a port
    corpus directory (the Converter's ``feat``; ref --test):
    ``<result>/units/<utt>.txt`` once per utterance and
    ``<result>/<target>/<utt>.wav`` per target (units only: no wavs). Sources are normalised with their own speaker's
    statistics. ``adaptive_buckets=K`` fits <= K edges to these lengths
    for this call only (``bucket_cost_model``, ``dispatch_cost_frames``:
    Converter.fit_buckets). The result holds the plan's _bucket_stats."""
    feats, names, srcs = load_corpus_split(dataset_path, split, limit, feat=converter.feat)
    return _convert_planned(
        converter, names, [f.shape[0] for f in feats], result_dir, target_speakers,
        lambda: converter.encode_units(feats, src_speakers=srcs),
        lambda spk_ids, tgt_names: converter.convert_features_multi(
            feats, spk_ids, tgt_names=tgt_names, src_speakers=srcs),
        sr, units_only, progress, adaptive_buckets, bucket_overhead_target, bucket_cost_model,
        dispatch_cost_frames,
    )


def convert_wav_dir(
    converter: Converter,
    wav_dir: str | Path,
    result_dir: str | Path,
    target_speakers: dict[str, int],
    sr: int = 16000,
    limit: int | None = None,
    units_only: bool = False,
    progress=None,
    adaptive_buckets: int | None = None,
    bucket_overhead_target: float | None = None,
    bucket_cost_model: str = "frames",
    dispatch_cost_frames: float = 0.0,
) -> dict:
    """Corpus conversion straight from a directory of wavs (ref --test
    iterates english/test/*.wav): ``<result>/units/<utt>.txt`` once per
    utterance and ``<result>/<target>/<utt>.wav`` per target (units only:
    no wavs). Source speakers are unknown for a flat directory, so
    speaker_norm uses the global statistics. ``adaptive_buckets=K`` fits
    <= K edges to the trimmed lengths for this call only, as
    convert_corpus. The result holds
    the plan's _bucket_stats."""
    wav_paths = sorted(Path(wav_dir).glob("*.wav"))
    if limit:
        wav_paths = wav_paths[:limit]
    if not wav_paths:
        raise ValueError(f"no .wav files in {wav_dir}")
    # the plan is made on the lengths the path will see: trim here once and
    # skip the (idempotent) trim inside the conversion call
    ys = [trim_silence(load_wav(p, sr), converter.acfg.top_db) for p in wav_paths]
    return _convert_planned(
        converter, [p.stem for p in wav_paths], [dsp_audio.n_frames_for(len(y), converter.acfg) for y in ys],
        result_dir, target_speakers,
        lambda: converter.encode_units_from_wavs(ys, trim=False),
        lambda spk_ids, tgt_names: converter.convert_wavs_multi(
            ys, spk_ids, tgt_names=tgt_names if converter.stats is not None else None, trim=False),
        sr, units_only, progress, adaptive_buckets, bucket_overhead_target, bucket_cost_model,
        dispatch_cost_frames,
    )


def convert_single(
    converter: Converter,
    wav_path: str | Path,
    target: str,
    target_id: int,
    result_dir: str | Path,
    sr: int | None = None,
) -> dict:
    """Single (source wav, target speaker) path (ref --test_single)."""
    sr = sr or converter.acfg.sr
    y = load_wav(wav_path, sr)
    units, wav = converter.convert_wav(y, target_id, tgt_name=target)
    result_dir = Path(result_dir)
    stem = Path(wav_path).stem
    write_units(result_dir / "units" / f"{stem}.txt", units)
    out = result_dir / target / f"{stem}.wav"
    save_wav(out, wav, sr)
    return {"units": str(result_dir / "units" / f"{stem}.txt"), "wav": str(out)}
