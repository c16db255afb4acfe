"""Driver ``serve``: open-loop arrivals into ``ConversionService.submit``,
in process, with no HTTP.

Traffic parameters: ``rate_per_s`` (the offered rate, fixed in the file),
``window_ms`` and ``max_batch`` (the service's), ``pool`` distinct
utterances of ``duration_s``'s log-normal, each request one of them (in a
seeded order) to one target (the configuration's targets in equal
shares, in a seeded order), gaps the quantiles of an exponential of mean
1 / rate in a seeded order, ``trim``, ``check_sample`` (requests judged),
``trace_seconds`` (the traced stretch after the window) and
``warm_rows`` (the dispatch sizes warmed on every bucket the pool
reaches).

Each request is timed from when it was due until its answer is ready;
``serve_p95_ms`` is the 95th percentile over every request due in the
window, a failed one counting as never answered (its latency the time
waited for it). How late the generator sent is printed on standard error.
``correct`` judges a sample of the answered requests, drawn from the seed
with the longest among them.
"""

from __future__ import annotations

import math
import sys
import time
from concurrent import futures

import numpy as np
import torch

from benchmark.core import conversion, traffic

WAIT_S = 60.0  # the longest wait for an answer after the window closes


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
        self.pool = traffic.utterances(tr["duration_s"], tr["pool"], self.seed, ac["sr"], stream=1)
        self.conv = self.model.program(tr["max_batch"], tr["bucket_frames"])
        from zerospeech_tts_tpu_torch.serve import ConversionService

        self.svc = ConversionService(self.conv, self.model.speakers, window_ms=tr["window_ms"],
                                     max_batch=tr["max_batch"])
        self._warm()

    def schedule(self, seconds: float) -> None:
        """Requests due in [0, seconds + trace_seconds): due time, pool
        index and target index of each."""
        tr = self.tr
        n = math.ceil(tr["rate_per_s"] * (seconds + tr["trace_seconds"]) * 1.25) + 16
        g = traffic.rng(self.seed, 2)
        self.due = np.cumsum(g.permutation(traffic.gaps(n, tr["rate_per_s"])))
        self.which = np.resize(g.permutation(len(self.pool)), n)
        self.tgt = traffic.balanced(n, len(self.targets), g)
        self.sent = np.full(n, np.nan)
        self.done = np.full(n, np.nan)
        self.futs: dict[int, futures.Future] = {}
        self.next = 0

    def _warm(self) -> None:
        """Every dispatch size of ``warm_rows`` on every bucket the pool
        reaches, through the service: bursts of requests of one bucket's
        length, each answered before the next."""
        hop = self.model.ac["hop_length"]
        from zerospeech_tts_tpu_torch.dsp.audio import n_frames_for

        buckets = sorted({self.conv._bucket_of(n_frames_for(len(w), self.conv.acfg)) for w in self.pool})
        g = traffic.rng(self.seed, 3)
        for tb in buckets:
            wav = traffic.speechlike((tb - 1) * hop, g)  # tb frames: the bucket's own length
            for k in self.tr["warm_rows"]:
                reqs = [self.svc.submit(wav, (self.targets[0],), trim=self.tr["trim"]) for _ in range(k)]
                for r in reqs:
                    r.result(WAIT_S)

    def _send(self, t0: float, until: float) -> list[int]:
        """Send every request due before ``until`` (s after t0), each at its
        due time or as soon after as the generator gets to it."""
        sent = []
        while self.next < len(self.due) and self.due[self.next] < until:
            i = self.next
            self.next += 1
            wait = t0 + self.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.sent[i] = time.perf_counter() - t0
            try:
                req = self.svc.submit(self.pool[self.which[i]], (self.targets[self.tgt[i]],), trim=self.tr["trim"])
            except Exception as e:  # noqa: BLE001 - a refused request is a failed one
                print(f"serve: request {i} refused: {e!r}", file=sys.stderr)
                continue
            self.futs[i] = req.future
            req.future.add_done_callback(lambda f, i=i: self.done.__setitem__(i, time.perf_counter() - t0))
            sent.append(i)
        return sent

    def _wait(self, idx, deadline: float) -> None:
        """Wait for the answers of ``idx`` until ``deadline`` (s after t0)."""
        fs = [self.futs[i] for i in idx]
        futures.wait(fs, timeout=max(0.0, self.t0 + deadline - time.perf_counter()))
        for i in idx:  # a future's callbacks run just after it is done
            while self.futs[i].done() and np.isnan(self.done[i]):
                time.sleep(0.0005)

    def _answered(self, i: int) -> bool:
        f = self.futs.get(i)
        return f is not None and f.done() and f.exception() is None

    def window(self, seconds: float) -> dict:
        self.schedule(seconds)
        self.seconds = seconds
        d0, s0 = self.svc.dispatches, self.svc.served
        self.t0 = t0 = time.perf_counter() + 0.05
        idx = self._send(t0, seconds)
        self._wait(idx, seconds + WAIT_S)
        waited = time.perf_counter() - t0
        due = range(self.next)
        answered = [i for i in due if self._answered(i)]
        self.attempted, self.failed = len(due), len(due) - len(answered)
        lat = np.array([(self.done[i] if self._answered(i) else waited) - self.due[i] for i in due])
        late = np.nan_to_num(self.sent[:self.next] - self.due[:self.next], nan=0.0)
        print(f"serve: generator lateness p50 {np.percentile(late, 50) * 1e3:.3f} ms, "
              f"p95 {np.percentile(late, 95) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms over "
              f"{len(due)} requests", file=sys.stderr)
        self.window_answered = answered
        return {"serve_p95_ms": float(np.percentile(lat, 95) * 1e3), "units": len(due), "elapsed": seconds,
                "dispatches": self.svc.dispatches - d0, "served": self.svc.served - s0}

    def tail(self) -> list[int]:
        idx = self._send(self.t0, self.seconds + self.tr["trace_seconds"])
        self._wait(idx, self.seconds + self.tr["trace_seconds"] + WAIT_S)
        return idx

    def units_of(self, idx) -> int:
        return len(idx)

    def release(self) -> None:
        self.svc.close()
        del self.svc, self.conv
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self) -> list[int]:
        """The judged requests: the longest answered one and a seeded
        sample of the others answered in the window."""
        ans = self.window_answered
        if not ans:
            return []
        longest = max(ans, key=lambda i: len(self.pool[self.which[i]]))
        rest = [i for i in ans if i != longest]
        g = traffic.rng(self.seed, 4)
        k = min(len(rest), self.tr["check_sample"] - 1)
        return [longest, *(rest[j] for j in sorted(g.choice(len(rest), size=k, replace=False)))]

    def check(self, flops: bool = False) -> dict:
        """The sample's readings, and ``unanswered``: the requests due in
        the window that never got an answer (refused, failed, or not
        within a minute of the close)."""
        items = []
        for i in self._sample():
            r, t = self.futs[i].result(), self.targets[self.tgt[i]]
            items.append((self.pool[self.which[i]], r["units"], [r["wavs"][t]], [self.tgt[i]]))
        res = (conversion.judge(self.model.reference(), items) if items
               else {"units_differ_share": 1.0, "consistency_gap": 1.0})
        return {**res, "unanswered": self.failed}

    def control(self, which: str = "precision") -> dict:
        side = self.model.side(which)
        items = []
        for i in self._sample():
            u, p = side(self.pool[self.which[i]], self.tr["trim"], [self.tgt[i]])
            items.append((self.pool[self.which[i]], u, p, [self.tgt[i]]))
        return conversion.judge(self.model.reference(), items)

