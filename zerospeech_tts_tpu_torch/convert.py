"""Converter / discrete-unit dumper in the challenge-exact configuration
(port of ``zerospeech_tts_tpu/convert.py``; ref convert.py --test /
--test_single).

Per length bucket and batch chunk, straight from int16 PCM:
frontend (kernel) -> source z-norm -> encoder (GRU kernel) -> MBV bits ->
decoder for all targets folded into one batch (GRU kernel) -> target
denorm -> Griffin-Lim (kernel) -> de-emphasis -> PCM16. f32 throughout.
Units are written one latent frame per line as space-separated 0/1 ints;
wavs are 16 kHz PCM16 at ``<result>/<target_speaker>/<utt>.wav``.

Not ported yet (ROADMAP): the h5-corpus paths, units-only dumps, adaptive
buckets and frame budgets, ``feat="mel"``, the bf16 configs and the
uint8/mu-law wires.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
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


class Converter:
    """Encoder + decoder on ``device``, converting PCM batches per padded
    length bucket. ``enc_state``/``dec_state`` are the port's state dicts
    (``params.from_flax``). On ``device="cuda"`` (the default) it runs the
    hand-written kernels and never falls back to the CPU; ``device="cpu"``
    runs their plain versions."""

    def __init__(
        self,
        hps: Hps,
        acfg: AudioConfig,
        enc_state: dict,
        dec_state: dict,
        gl_iters: int | None = None,
        batch_size: int = 8,
        bucket_frames: int = 64,
        stats=None,  # SpeakerStats when hps.speaker_norm (z-norm in/out)
        device: str | torch.device = "cuda",
    ):
        assert bucket_frames % hps.downsample == 0
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device is visible")
        self.hps, self.acfg, self.stats = hps, acfg, stats
        self.gl_iters = gl_iters if gl_iters is not None else acfg.gl_iters
        self.batch_size = batch_size
        self.bucket_frames = bucket_frames
        self.encoder = Encoder(hps)
        self.decoder = Decoder(hps)
        self.encoder.load_state_dict(enc_state)
        self.decoder.load_state_dict(dec_state)
        self.encoder.to(self.device).eval().requires_grad_(False)
        self.decoder.to(self.device).eval().requires_grad_(False)

    # ------------------------------------------------------------- buckets

    # Minimum nonzero bucket padding, in input frames. The encoder's widest
    # conv (bank kernel 8) reads 4 rows past the true boundary; with >= 4
    # pad rows those reads land in the mirror-filled region, which makes
    # padded encoding equal exact-length encoding (models/encoder.py).
    _MIN_PAD = 4

    def _bucket_of(self, t: int) -> int:
        """Padded frame count for a true frame count ``t``: ceil to
        bucket_frames, bumped a bucket when that leaves 1..3 pad frames."""
        tb = -(-t // self.bucket_frames) * self.bucket_frames
        if 0 < tb - t < self._MIN_PAD:
            tb += self.bucket_frames
        return tb

    # ---------------------------------------------------------------- core

    def _convert_core(self, x, spk, tgt_mean, tgt_std, tlens):
        """Normalised features x [B, T, F] -> (units [B, T/ds, emb] int32,
        PCM16 [n_tgt, B, (T-1)*hop] int16). ``tlens`` ([B] true frame
        counts) drives the length-masked encoder/decoder so bucket padding
        never changes the true frames' units or audio."""
        hps, acfg = self.hps, self.acfg
        zlens = (tlens + hps.downsample - 1) // hps.downsample
        logits = self.encoder(x, lengths=tlens)
        units = unit_bits(logits, hps.enc_mode)
        z = (
            discretize(logits, hps.enc_mode, hps.gumbel_temp, None)
            if hps.enc_mode == "continues"
            else units.to(torch.float32)
        )
        # Cross-target batched decode: fold the target axis into the batch
        # (batch-major, targets minor) so the decoder and its frame-rate GRU
        # run once at B * n_tgt rows, and the vocoder once over all of them.
        n_tgt, bsz = spk.shape
        z_all = z[:, None].expand(bsz, n_tgt, *z.shape[1:]).reshape(bsz * n_tgt, *z.shape[1:])
        spk_flat = spk.T.reshape(-1)
        xh = self.decoder(z_all, spk_flat, lengths=zlens.repeat_interleave(n_tgt))
        mean_all = tgt_mean[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        std_all = tgt_std[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        xh = torch.clamp(xh * std_all + mean_all, 0.0, 1.0)
        wav = dsp_audio.spectrogram2wav(xh, acfg, n_iters=self.gl_iters)  # [B*n_tgt, n]
        pcm = torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)
        return units, pcm.reshape(bsz, n_tgt, -1).transpose(0, 1)

    def _wav_batch(self, pcm, spk, src_mean, src_std, tgt_mean, tgt_std, slens):
        """int16 PCM [B, n_samp] -> frontend -> source z-norm -> core.
        ``slens`` ([B] true sample counts) gives exact tail reflection in
        the frontend and the true frame counts downstream."""
        y = pcm.to(torch.float32) * (1.0 / 32768.0)  # load_wav convention
        _, mag = dsp_audio.wav_to_features(y, self.acfg, length=slens)
        x = (mag - src_mean[:, None, :]) / src_std[:, None, :]
        tlens = 1 + slens // self.acfg.hop_length
        return self._convert_core(x, spk, tgt_mean, tgt_std, tlens)

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
        acfg, hps, dev = self.acfg, self.hps, self.device
        wavs = [np.asarray(w, np.float32) for w in wavs]
        if trim:
            wavs = [trim_silence(w, acfg.top_db) for w in wavs]
        n = len(wavs)
        if self.stats is not None:
            if tgt_names is None:
                raise ValueError(
                    "speaker_norm is on (Converter has stats) but tgt_names was "
                    "not given — conversion would denormalize with the WRONG "
                    "(global) statistics. Pass per-target names, or build the "
                    "Converter with stats=None to opt out."
                )
            s_mean, s_std = self.stats.arrays_for(src_speakers or ["__global__"] * n)
            t_mean, t_std = self.stats.arrays_for(tgt_names)
        else:
            s_mean = np.zeros((n, hps.n_feat), np.float32)
            s_std = np.ones((n, hps.n_feat), np.float32)
            t_mean = np.zeros((len(spk_ids), hps.n_feat), np.float32)
            t_std = np.ones((len(spk_ids), hps.n_feat), np.float32)
        t_mean_d, t_std_d = torch.from_numpy(t_mean).to(dev), torch.from_numpy(t_std).to(dev)

        units_out: list = [None] * n
        wavs_out: list[list] = [[None] * n for _ in spk_ids]
        buckets: dict[int, list[int]] = {}
        for i in np.argsort([-len(w) for w in wavs], kind="stable"):
            t = dsp_audio.n_frames_for(len(wavs[int(i)]), acfg)
            buckets.setdefault(self._bucket_of(t), []).append(int(i))

        ds, hop = hps.downsample, acfg.hop_length
        spk_arr = np.asarray(spk_ids, np.int64)[:, None]
        inflight = []  # launch every chunk first; reading back syncs
        for tb, idxs in buckets.items():
            n_samp = tb * hop - 1  # longest signal with tb frames
            for c0 in range(0, len(idxs), self.batch_size):
                chunk = idxs[c0 : c0 + self.batch_size]
                bs_c = _round_rows(len(chunk), self.batch_size)
                pcm = np.zeros((bs_c, n_samp), np.int16)
                sm = np.zeros((bs_c, hps.n_feat), np.float32)
                ss = np.ones((bs_c, hps.n_feat), np.float32)
                sl = np.full(bs_c, n_samp, np.int64)  # dummy rows act full-length
                for j, i in enumerate(chunk):
                    w = np.clip(np.rint(wavs[i] * 32768.0), -32768, 32767).astype(np.int16)
                    pcm[j, : len(w)] = w
                    sm[j], ss[j] = s_mean[i], s_std[i]
                    sl[j] = len(w)
                units, pcm_out = self._wav_batch(
                    torch.from_numpy(pcm).to(dev),
                    torch.from_numpy(np.tile(spk_arr, (1, bs_c))).to(dev),
                    torch.from_numpy(sm).to(dev), torch.from_numpy(ss).to(dev),
                    t_mean_d, t_std_d, torch.from_numpy(sl).to(dev),
                )
                inflight.append((chunk, units, pcm_out))

        for chunk, units_d, pcm_d in inflight:
            units, pcm = units_d.cpu().numpy(), pcm_d.cpu().numpy()  # pcm: [n_tgt, B, n]
            for j, i in enumerate(chunk):
                t_true = dsp_audio.n_frames_for(len(wavs[i]), acfg)
                units_out[i] = units[j][: -(-t_true // ds)].astype(np.int32)
                for k in range(len(spk_ids)):
                    wavs_out[k][i] = pcm[k, j][: max(t_true - 1, 1) * hop]
        return units_out, wavs_out

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


def convert_wav_dir(
    converter: Converter,
    wav_dir: str | Path,
    result_dir: str | Path,
    target_speakers: dict[str, int],
    sr: int = 16000,
    limit: int | None = None,
    progress=None,
) -> dict:
    """Corpus conversion straight from a directory of wavs (ref --test
    iterates english/test/*.wav): ``<result>/units/<utt>.txt`` once per
    utterance and ``<result>/<target>/<utt>.wav`` per target. Source
    speakers are unknown for a flat directory, so speaker_norm uses the
    global statistics."""
    result_dir = Path(result_dir)
    wav_paths = sorted(Path(wav_dir).glob("*.wav"))
    if limit:
        wav_paths = wav_paths[:limit]
    if not wav_paths:
        raise ValueError(f"no .wav files in {wav_dir}")
    ys = [load_wav(p, sr) for p in wav_paths]
    names = [p.stem for p in wav_paths]
    tgt_names = list(target_speakers)
    units_list, wavs_per_tgt = converter.convert_wavs_multi(
        ys,
        [target_speakers[t] for t in tgt_names],
        tgt_names=tgt_names if converter.stats is not None else None,
    )
    for utt, units in zip(names, units_list):
        write_units(result_dir / "units" / f"{utt}.txt", units)
    n_wav = 0
    for k, tgt_name in enumerate(tgt_names):
        for utt, wav in zip(names, wavs_per_tgt[k]):
            save_wav(result_dir / tgt_name / f"{utt}.wav", wav, sr)
            n_wav += 1
            if progress:
                progress(tgt_name, utt)
    return {"n_utterances": len(names), "n_wavs": n_wav, "result_dir": str(result_dir)}


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
