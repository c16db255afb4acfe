"""Driver ``convert``: a closed loop of whole passes of corpus conversion
through ``Converter.convert_wavs_multi``, the entry ``zstts convert
--from-wavs`` calls.

Traffic parameters: ``utterances`` (a pass), ``duration_s`` (median,
sigma, min, max of the log-normal), ``batch_size`` and ``bucket_frames``
(the Converter's), ``trim``, ``warm_passes`` and ``trace_passes``.
Every utterance goes to every target of the configuration.
``convert_audio_s_per_s`` is the input seconds of the passes completed
over the time from the window's start to the synchronised end of the last
pass begun in it. ``correct`` judges the last pass's outputs, every
utterance and every target.
"""

from __future__ import annotations

import time

import torch

from benchmark.core import conversion, traffic
from benchmark.core.counts import PEAK_FLOPS


class Cell:
    def __init__(self, c: dict, seed: int, device):
        self.c, self.seed, self.device = c, seed, device
        self.tr, cfg = c["traffic"], c["config"]
        self.model = conversion.Model(cfg, seed, device)
        self.targets = list(cfg["targets"])
        self.attempted = self.failed = 0
        self.flops = None

    def setup(self) -> None:
        tr, ac = self.tr, self.model.ac
        self.wavs = traffic.utterances(tr["duration_s"], tr["utterances"], self.seed, ac["sr"])
        self.audio_s = sum(len(w) for w in self.wavs) / ac["sr"]
        self.conv = self.model.program(tr["batch_size"], tr["bucket_frames"])
        self.ids = [self.model.speakers[t] for t in self.targets]
        for _ in range(tr["warm_passes"]):
            self._pass()
        from zerospeech_tts_tpu_torch.convert import _bucket_stats
        from zerospeech_tts_tpu_torch.dsp.audio import n_frames_for
        from zerospeech_tts_tpu_torch.dsp.wavio import trim_silence

        acfg = self.conv.acfg
        self.frames = [n_frames_for(len(trim_silence(w, acfg.top_db) if tr["trim"] else w), acfg) for w in self.wavs]
        self.bucket_stats = _bucket_stats(self.conv, self.frames)

    def _pass(self):
        with torch.profiler.record_function("bench.pass"):
            out = self.conv.convert_wavs_multi(self.wavs, self.ids, tgt_names=self.targets, trim=self.tr["trim"])
        if self.conv.device.type == "cuda":
            torch.cuda.synchronize()
        return out

    def window(self, seconds: float) -> dict:
        passes, t0 = 0, time.perf_counter()
        while True:
            self.out = self._pass()
            passes += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.attempted = passes * len(self.wavs)
        return {"convert_audio_s_per_s": passes * self.audio_s / elapsed, "units": passes, "elapsed": elapsed}

    def tail(self) -> int:
        n = self.tr["trace_passes"]
        for _ in range(n):
            self._pass()
        return n

    def units_of(self, n: int) -> int:
        return n

    def release(self) -> None:
        del self.conv
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, flops: bool = False) -> dict:
        units, pcm = self.out
        counted = [] if flops else None
        items = [(w, units[i], [p[i] for p in pcm], None) for i, w in enumerate(self.wavs)]
        res = conversion.judge(self.model.reference(), items, counted)
        if flops:
            self.flops = counted
        return res

    def control(self, which: str = "precision") -> dict:
        """The readings of a side put in the program's place (for
        calibration; conversion.Model.side)."""
        side = self.model.side(which)
        outs = [side(w, self.tr["trim"]) for w in self.wavs]
        items = [(w, u, p, None) for w, (u, p) in zip(self.wavs, outs)]
        return conversion.judge(self.model.reference(), items)

    # ------------------------------------------------ for the metrics

    def least_s(self, kernel: str) -> float:
        """Least time of ``kernel``'s work in one pass."""
        m = self.model
        return conversion.least_s(kernel, self.frames, len(self.targets), m.hp, m.ac, m.dtypes)

    def flop_s(self) -> float | None:
        """Least time of one pass at the peaks of the stated dtypes: the
        encoder's and decoder's operations (counted over the reference in
        the check) and the float32 frontend and Griffin-Lim."""
        if not self.flops:
            return None
        enc, dec = (sum(f[k] for f in self.flops) for k in (0, 1))
        return (enc / PEAK_FLOPS[self.model.dtypes["encoder"]] + dec / PEAK_FLOPS[self.model.dtypes["decoder"]]
                + conversion.fft_flop_s(self.frames, len(self.targets), self.model.ac))

