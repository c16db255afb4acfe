"""Conversion of one utterance in plain PyTorch, at its own length:

    trim -> PCM16 -> frontend -> source z-norm -> encoder -> MBV units ->
    decoder for each target -> target denorm -> amp ** gl_power ->
    Griffin-Lim -> de-emphasis -> PCM16

and the judgement of a converted utterance against it. Units are judged
bit by bit. Griffin-Lim with momentum is chaotic (a change of 1e-5 in its
input moves the waveform by tens of percent), so a synthesised signal is
judged by what it says: its spectral consistency with the magnitudes the
reference decoder gives for the judged units, beside the consistency the
reference's own Griffin-Lim reaches on the same magnitudes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import dsp, model
from benchmark.reference.precision import exact


@dataclass
class Converter:
    """The plain conversion of a configuration: encoder and decoder
    parameters (state-dict names, in the configuration's dtypes), the
    source statistics (mean, std [F]) and each target's (id, mean, std)."""

    hp: dict
    ac: dict
    enc: dict
    dec: dict
    src: tuple
    targets: list
    q: object = exact

    def __post_init__(self):
        self.device = self.enc["head.weight"].device
        self.bs = dsp.bases(self.ac, self.device)

    def features(self, wav: np.ndarray, trim: bool) -> torch.Tensor:
        y = dsp.trim_silence(wav, self.ac["top_db"]) if trim else wav
        mag = dsp.features(dsp.pcm16(y), self.ac, self.bs, self.device)
        return (mag - self.src[0]) / self.src[1]

    def units(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised features [T, F] -> unit bits [ceil(T / ds), emb]."""
        return model.units(model.encoder(self.enc, self.hp, x[None], self.q))[0]

    def target_amps(self, units: torch.Tensor, t: int, which=None) -> torch.Tensor:
        """Unit bits -> the magnitudes Griffin-Lim is asked for, one row for
        each target of ``which`` (indices into ``targets``, default all):
        [n, t, F] (frames past t dropped)."""
        tg = [self.targets[i] for i in (range(len(self.targets)) if which is None else which)]
        z = units.to(torch.float32)[None].expand(len(tg), *units.shape)
        spk = torch.tensor([tid for tid, _, _ in tg], device=self.device)
        xh = model.decoder(self.dec, self.hp, z, spk, self.q).float()[:, :t]
        mean = torch.stack([m for _, m, _ in tg])[:, None]
        std = torch.stack([s for _, _, s in tg])[:, None]
        xh = torch.clamp(xh * std + mean, 0.0, 1.0)
        return dsp.db_norm_to_amp(xh, self.ac) ** self.ac["gl_power"]

    def synthesise(self, amps: torch.Tensor) -> np.ndarray:
        """[n, T, F] magnitudes -> int16 PCM [n, (T - 1) x hop]."""
        wav = dsp.griffin_lim(amps.contiguous(), self.ac, self.bs, self.ac["gl_iters"])
        return dsp.pcm_out(dsp.de_emphasis(wav.cpu().numpy(), self.ac["preemphasis"]))

    @torch.no_grad()
    def convert(self, wav: np.ndarray, trim: bool = True, which=None):
        """(unit bits [T', emb] int32, PCM [n, (T - 1) x hop] int16 for the
        targets of ``which``)."""
        x = self.features(wav, trim)
        u = self.units(x)
        return u.cpu().numpy(), self.synthesise(self.target_amps(u, x.shape[0], which))

    @torch.no_grad()
    def judge(self, wav: np.ndarray, units: np.ndarray, pcm, trim: bool = True, which=None,
              flops: list | None = None) -> dict:
        """Readings of one converted utterance: ``units_differ``, how many
        of its ``units_bits`` unit bits differ from the reference's (all of
        them at another shape), and ``consistency_gap``: for each target of ``which`` the
        consistency of its PCM (``pcm[k]``) with the reference decoder's
        magnitudes for ``units``, less the consistency of the reference's
        own synthesis of them; the largest over the targets. With ``flops``
        (a list), the operations of the encoder and of the decoder are
        counted (``FlopCounterMode``) and appended to it as a pair."""
        x = self.features(wav, trim)
        t = x.shape[0]
        counters = [FlopCounterMode(display=False) if flops is not None else contextlib.nullcontext()
                    for _ in range(2)]
        with counters[0]:
            ref_units = self.units(x).cpu().numpy()
        units = np.asarray(units)
        same = units.shape == ref_units.shape
        differ = int(np.sum(units != ref_units)) if same else ref_units.size
        with counters[1]:  # the magnitudes come from well-formed units even where the judged ones are not
            amps = self.target_amps(torch.from_numpy(units if same else ref_units).to(self.device), t, which)
        if flops is not None:
            flops.append(tuple(c.get_total_flops() for c in counters))
        own = self.synthesise(amps)
        gap = max(dsp.consistency(np.asarray(pcm[k]), amps[k], self.ac, self.bs)
                  - dsp.consistency(own[k], amps[k], self.ac, self.bs) for k in range(amps.shape[0]))
        return {"units_differ": differ, "units_bits": ref_units.size, "consistency_gap": gap, "frames": t}
