"""Serving runtime of the PyTorch port: a persistent conversion service and
a stdlib HTTP front (counterpart of ``zerospeech_tts_tpu/serve.py``; the
reference repo is batch CLI only).

A long-lived process keeps one :class:`~zerospeech_tts_tpu_torch.convert.Converter`
on the card (its kernels built at the first request, or by ``warmup``), and
concurrent requests micro-batch onto it:

* :class:`ConversionService` — one dispatch worker thread makes every call
  into the Converter (one CUDA stream, no contention on the card).
  Requests queue per plan key (the sorted, de-duplicated tuple of target
  speakers, at most ``MAX_TARGETS``; ``()`` = units only). The worker takes
  the key whose oldest request has waited longest, waits up to
  ``window_ms`` for more requests of that key (up to ``max_batch``), and
  converts the gathered utterances in one Converter call. Silence is
  trimmed at submit time, so requests with different trim settings share a
  batch. When a batch fails, its requests are retried one by one, so one
  bad input cannot fail its companions; a ValueError or KeyError is the
  request's own, and any other error in two solo retries fails the rest
  of the batch fast. ``dispatches`` counts Converter calls, ``served``
  requests answered.
* :func:`serve_http` — a ``ThreadingHTTPServer``. Handler threads block on
  their request's future, so the worker sees every request in flight:

      GET  /healthz           -> {"ok": true, platform, device, speakers, dispatches, served}
      GET  /speakers          -> {"speakers": [...]}
      POST /convert?targets=V001,V002[&trim=0]   body: WAV bytes
      POST /units[?trim=0]                        body: WAV bytes
      (both POSTs also take JSON {"pcm16_b64": ..., "sr": N})

  /convert returns {"units": <challenge text format>, "wavs": {target:
  base64 PCM16 WAV}}; /units returns the units alone.

Admission: a body above ``max_body_bytes`` is refused before it is read,
and an utterance above ``max_frames`` (32,768 frames, ~6.8 min) at submit.

Start it with ``python -m zerospeech_tts_tpu_torch serve --from-export B``
(or ``-dataset_path DS -ckpt_dir CK``), ``--warmup-buckets 256,512`` to
build the kernels and run those buckets before the first client, and the
Converter's ``--bf16 --enc-f32 --feat --gl-iters --wire-mulaw`` settings
(the mu-law wire is the Converter's own: requests and answers stay PCM16).
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from collections import deque
from concurrent import futures
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from zerospeech_tts_tpu_torch.convert import units_text
from zerospeech_tts_tpu_torch.dsp.audio import n_frames_for
from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, resample, trim_silence

MAX_TARGETS = 16  # target speakers a request: bounds one dispatch's decoder rows


class _Request:
    """One utterance waiting for a dispatch."""

    __slots__ = ("wav", "key", "seq", "future")

    def __init__(self, wav: np.ndarray, key: tuple, seq: int):
        self.wav = wav
        self.key = key
        self.seq = seq
        self.future = Future()

    def result(self, timeout: float | None = None):
        try:
            return self.future.result(timeout)
        except futures.TimeoutError:  # 3.10: not an alias of the builtin TimeoutError
            raise TimeoutError("conversion request timed out") from None


class ConversionService:
    """Micro-batching front over a warm Converter.

    ``speakers`` maps target speaker name -> id (the corpus speaker map).
    ``window_ms`` bounds the latency a request may wait for companions;
    ``max_batch`` (default: the Converter's batch size) the requests a
    dispatch; ``request_timeout`` the wait of :meth:`convert`."""

    def __init__(
        self,
        converter,
        speakers: dict[str, int],
        window_ms: float = 5.0,
        max_batch: int | None = None,
        request_timeout: float = 900.0,
        max_body_bytes: int = 64 << 20,
        max_frames: int = 32768,
    ):
        self.converter = converter
        self.speakers = dict(speakers)
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch or converter.batch_size
        self.request_timeout = request_timeout
        self.max_body_bytes = max_body_bytes  # 0: unlimited
        self.max_frames = max_frames  # 0: unlimited
        self.dispatches = 0  # Converter calls
        self.served = 0  # requests answered
        self._seq = 0
        self._queues: dict[tuple, deque[_Request]] = {}
        self._cv = threading.Condition()
        self._stopping = False
        self._worker = threading.Thread(target=self._worker_loop, name="zstts-dispatch", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client

    def plan_key(self, targets) -> tuple:
        """Canonical batching key: the sorted unique target names (a
        response is keyed by name, so order and duplicates carry nothing)."""
        uniq = sorted(dict.fromkeys(targets))
        if len(uniq) > MAX_TARGETS:
            raise ValueError(f"{len(uniq)} target speakers in one request (max {MAX_TARGETS}); "
                             "split the request")
        for t in uniq:
            if t not in self.speakers:
                raise KeyError(f"unknown target speaker {t!r}")
        return tuple(uniq)

    def submit(self, wav: np.ndarray, targets, trim: bool = True) -> _Request:
        """Enqueue one utterance; returns a request carrying a future.
        ``targets=()`` means units only (no synthesis)."""
        key = self.plan_key(targets)
        wav = np.asarray(wav, np.float32)
        acfg = self.converter.acfg
        if trim:
            wav = trim_silence(wav, acfg.top_db)
        if len(wav) < acfg.hop_length + 1:
            raise ValueError("utterance shorter than one frame after trim")
        n_frames = n_frames_for(len(wav), acfg)
        if self.max_frames and n_frames > self.max_frames:
            raise ValueError(f"utterance is {n_frames} frames, above the service cap {self.max_frames} "
                             "(split long audio client-side)")
        with self._cv:
            if self._stopping:
                raise RuntimeError("service is shut down")
            req = _Request(wav, key, self._seq)
            self._seq += 1
            self._queues.setdefault(key, deque()).append(req)
            self._cv.notify_all()
        return req

    def convert(self, wav, targets, trim: bool = True, timeout: float | None = None):
        """Blocking wrapper around :meth:`submit`."""
        return self.submit(wav, targets, trim=trim).result(
            self.request_timeout if timeout is None else timeout)

    def close(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._worker.join(timeout=10)

    def warmup(self, bucket_frames: list[int], n_targets: int = 1) -> float:
        """Run one utterance of each bucket through the n_targets-wide
        conversion and through units only, before the first client: the
        first use builds the kernels (nvcc, csrc/) and each bucket's shapes
        meet the caching allocator once. Uses the Converter directly (no
        dispatch is counted). Returns the seconds spent."""
        conv = self.converter
        hop = conv.acfg.hop_length
        pairs = sorted(self.speakers.items())[: max(1, n_targets)]  # ids and names of the same speakers
        tgt_names = [n for n, _ in pairs]
        tgt_ids = [i for _, i in pairs]
        t0 = time.monotonic()
        for tb in bucket_frames:
            tb = -(-int(tb) // conv.bucket_frames) * conv.bucket_frames
            wav = np.zeros(tb * hop - 1, np.float32)
            wav[::hop] = 0.1  # clicks: not silence
            conv.convert_wavs_multi([wav], tgt_ids, tgt_names=tgt_names if conv.stats is not None else None,
                                    trim=False)
            conv.encode_units_from_wavs([wav], trim=False)
        return time.monotonic() - t0

    # ------------------------------------------------------------- worker

    def _oldest_key(self):
        """The key whose head request has waited longest (FIFO across keys)."""
        best, best_seq = None, None
        for k, q in self._queues.items():
            if q and (best_seq is None or q[0].seq < best_seq):
                best, best_seq = k, q[0].seq
        return best

    def _worker_loop(self):
        while True:
            with self._cv:
                key = self._oldest_key()
                while key is None and not self._stopping:
                    self._cv.wait(timeout=0.1)
                    key = self._oldest_key()
                if key is None and self._stopping:
                    return
                q = self._queues[key]
                deadline = time.monotonic() + self.window_s  # the micro-batch window
                while len(q) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = [q.popleft() for _ in range(min(len(q), self.max_batch))]
                if not q:
                    del self._queues[key]  # drained keys must not accumulate
            try:
                self._run(key, batch)
            except BaseException as batch_err:  # noqa: BLE001 - the worker must keep serving
                self._retry_solo(key, batch, batch_err)
            else:
                self.served += len(batch)

    def _retry_solo(self, key: tuple, batch: list[_Request], batch_err: BaseException) -> None:
        """A failed batch, one request at a time: a solo batch's own error
        goes to its owner (a rerun cannot differ); ValueError and KeyError
        are a request's own and never stop the retries; any other error in
        two solo retries is taken as systemic and fails the rest at once."""
        if len(batch) == 1:
            batch[0].future.set_exception(batch_err)
            return
        systemic: BaseException | None = None
        solo_failures = 0
        for r in batch:
            if r.future.done():
                continue
            if systemic is not None:
                r.future.set_exception(systemic)
                continue
            try:
                self._run(key, [r])
                self.served += 1
            except BaseException as solo_err:  # noqa: BLE001
                r.future.set_exception(solo_err)
                if not isinstance(solo_err, (ValueError, KeyError)):
                    solo_failures += 1
                    if solo_failures >= 2:
                        systemic = solo_err

    def _run(self, key: tuple, batch: list[_Request]) -> None:
        conv = self.converter
        wavs = [r.wav for r in batch]
        if key == ():  # units only
            units = conv.encode_units_from_wavs(wavs, trim=False)
            self.dispatches += 1
            results = [{"units": u} for u in units]
        else:
            units, wavs_out = conv.convert_wavs_multi(
                wavs, [self.speakers[t] for t in key],
                tgt_names=list(key) if conv.stats is not None else None, trim=False,
            )
            self.dispatches += 1
            results = [{"units": units[i], "wavs": {t: wavs_out[k][i] for k, t in enumerate(key)}}
                       for i in range(len(batch))]
        for r, res in zip(batch, results):  # all computed before any is resolved
            r.future.set_result(res)


# ------------------------------------------------------------------ HTTP


def wav_bytes(pcm16: np.ndarray, sr: int) -> bytes:
    """A PCM16 WAV file's bytes."""
    import scipy.io.wavfile

    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, sr, np.asarray(pcm16, np.int16))
    return buf.getvalue()


class _Handler(BaseHTTPRequestHandler):
    service: ConversionService = None  # set by serve_http
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - http.server API
        path = urlparse(self.path).path
        svc = self.service
        if path == "/healthz":
            dev = svc.converter.device
            self._json(200, {"ok": True, "platform": "gpu" if dev.type == "cuda" else dev.type,
                             "device": str(dev), "speakers": len(svc.speakers),
                             "dispatches": svc.dispatches, "served": svc.served})
        elif path == "/speakers":
            self._json(200, {"speakers": sorted(svc.speakers)})
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def _read_wav(self) -> np.ndarray:
        n = int(self.headers.get("Content-Length", 0))
        cap = self.service.max_body_bytes
        if cap and n > cap:
            # refused before reading: the unread body would poison keep-alive
            self.close_connection = True
            raise ValueError(f"request body {n} bytes exceeds the {cap}-byte cap")
        body = self.rfile.read(n)
        sr = self.service.converter.acfg.sr
        if self.headers.get("Content-Type", "").startswith("application/json"):
            obj = json.loads(body)
            pcm = np.frombuffer(base64.b64decode(obj["pcm16_b64"]), np.int16)
            return resample(pcm.astype(np.float32) / 32768.0, int(obj.get("sr", sr)), sr)
        return load_wav(io.BytesIO(body), sr)  # a WAV file (any rate, any width)

    def do_POST(self):  # noqa: N802 - http.server API
        url = urlparse(self.path)
        q = parse_qs(url.query)
        trim = q.get("trim", ["1"])[0].lower() not in ("0", "false", "no")
        try:
            wav = self._read_wav()
            if url.path == "/convert":
                targets = tuple(t for part in q.get("targets", []) for t in part.split(",") if t)
                if not targets:
                    self._json(400, {"error": "targets query parameter required"})
                    return
                res = self.service.convert(wav, targets, trim=trim)
                sr = self.service.converter.acfg.sr
                self._json(200, {"units": units_text(res["units"]),
                                 "wavs": {t: base64.b64encode(wav_bytes(w, sr)).decode()
                                          for t, w in res["wavs"].items()}})
            elif url.path == "/units":
                res = self.service.convert(wav, (), trim=trim)
                self._json(200, {"units": units_text(res["units"])})
            else:
                self._json(404, {"error": f"unknown path {url.path}"})
        except (KeyError, ValueError) as e:
            self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - the handler reports it to the client
            self._json(500, {"error": f"{type(e).__name__}: {e}"})


def serve_http(service: ConversionService, host: str = "127.0.0.1", port: int = 8571) -> ThreadingHTTPServer:
    """Bind and return the server (the caller runs serve_forever and
    shutdown; port 0 picks a free one, ``server_address`` names it)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)
