"""What the conversion cells share: the program's Converter built from
the benchmark's weights and statistics, the plain reference built from
the same, the judgement of converted utterances against it, and the
least work of a conversion for the rooflines.

Targets and the source statistics: speaker ids 0 .. n_speakers - 1, the
configuration's targets the last ids; sources are z-scored with the
global statistics (the port's default for wavs of unknown speakers).
"""

from __future__ import annotations

import math

import torch

from benchmark.core import counts, weights
from benchmark.reference import convert as ref_convert
from benchmark.reference.precision import ROUNDINGS, exact

GLOBAL = "__global__"


def speaker_map(hp: dict, targets) -> dict[str, int]:
    n = hp["n_speakers"]
    out = {f"S{i:03d}": i for i in range(n - len(targets))}
    out.update({t: n - len(targets) + k for k, t in enumerate(targets)})
    return out


class Model:
    """The benchmark's inputs of a conversion cell: weights, statistics,
    speaker map, from the seed."""

    def __init__(self, config: dict, seed: int, device):
        self.hp, self.ac, self.dtypes = config["hps"], config["audio"], config["dtypes"]
        self.targets = list(config["targets"])
        self.speakers = speaker_map(self.hp, self.targets)
        self.params = weights.make_params(self.hp, ("enc", "dec"), seed, device)
        self.mean, self.std = weights.make_stats([GLOBAL, *self.targets], self.hp["n_feat"], seed)
        self.device = device

    def program(self, batch_size: int, bucket_frames: int):
        """The port's Converter, as ``zstts convert`` builds it."""
        from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
        from zerospeech_tts_tpu_torch.convert import Converter
        from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats

        return Converter(Hps.from_dict(self.hp), AudioConfig.from_dict(self.ac), self.params["enc"],
                         self.params["dec"], batch_size=batch_size, bucket_frames=bucket_frames,
                         stats=SpeakerStats(self.mean, self.std), device=self.device,
                         compute_dtype=self.dtypes["decoder"], encoder_dtype=self.dtypes["encoder"])

    def reference(self, q=exact) -> ref_convert.Converter:
        """The plain conversion, its modules in the configuration's dtypes."""
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        enc = {k: v.to(dt[self.dtypes["encoder"]]) for k, v in self.params["enc"].items()}
        dec = {k: v.to(dt[self.dtypes["decoder"]]) for k, v in self.params["dec"].items()}
        t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        tg = [(self.speakers[n], t(self.mean[n]), t(self.std[n])) for n in self.targets]
        return ref_convert.Converter(self.hp, self.ac, enc, dec, (t(self.mean[GLOBAL]), t(self.std[GLOBAL])), tg, q)

    def side(self, which: str):
        """A side to put in the program's place, (units, PCM) of (wav,
        target indices): ``precision``, the reference one precision below
        the configuration's; ``gl_half``, the reference with Griffin-Lim
        cut to half its iterations; ``answer_altered``, the reference with
        every synthesised signal halved."""
        from benchmark.reference.precision import CONTROL_OF

        ref = self.reference(ROUNDINGS[CONTROL_OF[self.dtypes["decoder"]]] if which == "precision" else exact)
        if which == "gl_half":
            ref.ac = dict(ref.ac, gl_iters=ref.ac["gl_iters"] // 2)
        elif which not in ("precision", "answer_altered"):
            raise ValueError(f"no side {which!r}")

        def convert(wav, trim, which_targets=None):
            u, p = ref.convert(wav, trim=trim, which=which_targets)
            return u, (p // 2 if which == "answer_altered" else p)
        return convert


def judge(ref, items, flops: list | None = None) -> dict:
    """Readings over converted utterances, ``items`` of (wav, units, PCM
    rows, target indices): the share of all their unit bits that differ
    from the reference's, and the worst target's consistency gap."""
    differ, bits, gap = 0, 0, -math.inf
    for wav, units, pcm, which in items:
        r = ref.judge(wav, units, pcm, which=which, flops=flops)
        differ, bits, gap = differ + r["units_differ"], bits + r["units_bits"], max(gap, r["consistency_gap"])
    return {"units_differ_share": differ / max(bits, 1), "consistency_gap": gap}


def least_s(kernel: str, frames, n_targets: int, hp: dict, ac: dict, dtypes: dict) -> float:
    """The card's least time for ``kernel``'s share of converting
    utterances of these true frame counts to ``n_targets`` targets, each
    at its own length (no padding, no dummy rows)."""
    total = 0.0
    for t in frames:
        if kernel == "griffin_lim":
            total += counts.bound_s(*counts.griffin_lim(n_targets, t, ac))
        elif kernel == "gru_fwd":
            zl = -(-t // hp["downsample"])
            he, hd = hp["emb_size"] // 2, hp["conv_channels"]
            enc = counts.gru_fwd(1, zl, he, dtypes["encoder"])
            dec = counts.gru_fwd(n_targets, zl * hp["downsample"], hd, dtypes["decoder"])
            total += 2 * counts.bound_s(*enc, dtypes["encoder"]) + counts.bound_s(*dec, dtypes["decoder"])
        else:
            raise ValueError(f"no least work for {kernel!r} in conversion")
    return total


def fft_flop_s(frames, n_targets: int, ac: dict) -> float:
    """Seconds at the float32 peak of the operations of the frontend's
    linear magnitudes (window, rfft, magnitude, dB norm) and of
    Griffin-Lim, which run in float32 in every configuration, over
    utterances of these frame counts (the model's own operations are
    counted by FlopCounterMode over the reference)."""
    nf = ac["n_fft"] // 2 + 1
    front = ac["win_length"] + counts.rfft_flops(ac["n_fft"]) + 9 * nf
    fl = sum(t * front + counts.griffin_lim(n_targets, t, ac)[0] for t in frames)
    return fl / counts.PEAK_FLOPS["float32"]
