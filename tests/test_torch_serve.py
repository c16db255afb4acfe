"""PyTorch port, serving: the micro-batching ConversionService and its
stdlib HTTP front (serve.py), modelled on tests/test_serve.py and held
against the JAX package's ConversionService on the same parameters and
wavs; the ``serve`` verb of the CLI. Loopback port 0 only, a tiny model
with seeded weights on the CPU: the service contract (batching, results
per request, isolation of errors, wire formats) is under test, not audio
quality."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.serve import ConversionService as JaxConversionService
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter, units_text
from zerospeech_tts_tpu_torch.export import save_export
from zerospeech_tts_tpu_torch.params import from_flax, init_params
from zerospeech_tts_tpu_torch.serve import ConversionService, serve_http

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
SPEAKERS = {"V001": 0, "V002": 1}


@pytest.fixture(scope="module")
def model(tiny_hps):
    h = tiny_hps.replace(n_feat=129)
    return h, init_params(h, seed=0)


@pytest.fixture(scope="module")
def service(model):
    h, tree = model
    enc, dec = from_flax(tree)
    conv = Converter(h, AudioConfig(**ACFG), enc, dec, batch_size=2, bucket_frames=32, device="cpu")
    svc = ConversionService(conv, SPEAKERS, window_ms=120.0, max_batch=2)
    yield svc
    svc.close()


def _tone(n=3000, f=220.0, sr=16000):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _serving(service):
    httpd = serve_http(service, host="127.0.0.1", port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _wav_body(y):
    buf = io.BytesIO()
    scipy.io.wavfile.write(buf, 16000, (y * 32767).astype(np.int16))
    return buf.getvalue()


def test_service_convert_roundtrip(service):
    res = service.convert(_tone(), ("V001",), trim=False)
    assert set(res["wavs"]) == {"V001"}
    assert res["units"].ndim == 2 and set(np.unique(res["units"])) <= {0, 1}
    assert res["wavs"]["V001"].dtype == np.int16 and len(res["wavs"]["V001"]) > 0


def test_service_micro_batches_same_key(service):
    """Two same-target requests enqueued while the test holds the service's
    lock (an RLock) share ONE dispatch; each gets its own result."""
    d0 = service.dispatches
    with service._cv:
        reqs = [service.submit(_tone(f=220.0 + 60 * i), ("V001", "V002"), trim=False) for i in range(2)]
    results = [r.result(timeout=300) for r in reqs]
    assert results[0]["units"].shape == results[1]["units"].shape
    assert not np.array_equal(results[0]["wavs"]["V001"], results[1]["wavs"]["V001"])
    assert service.dispatches - d0 == 1


def test_service_units_only_and_errors(service):
    res = service.convert(_tone(), (), trim=False)
    assert "wavs" not in res and res["units"].shape[1] == service.converter.hps.emb_size
    with pytest.raises(KeyError):
        service.submit(_tone(), ("NOSUCH",))
    with pytest.raises(ValueError):
        service.submit(np.zeros(8, np.float32), ("V001",), trim=False)
    assert service.convert(_tone(), ("V001",), trim=False)["units"].size > 0  # the worker is not wedged


def test_service_units_match_jax_service(service, model):
    """The JAX ConversionService over the JAX Converter on the same
    parameters and wavs: the port's service returns the same units for
    /convert and /units requests (a micro-batch of two, trimmed)."""
    h, tree = model
    jconv = JaxConverter(h, JaxAudioConfig(**ACFG), {"params": tree["enc"]}, {"params": tree["dec"]},
                         batch_size=2, bucket_frames=32, gru_impl="scan")
    jsvc = JaxConversionService(jconv, SPEAKERS, window_ms=120.0, max_batch=2)
    try:
        wavs = [np.concatenate([np.zeros(800, np.float32), _tone(n=2500 + 900 * i, f=180 + 70 * i)])
                for i in range(2)]
        for targets in (("V002", "V001"), ()):
            mine = [r.result(300) for r in [service.submit(w, targets) for w in wavs]]
            ref = [r.result(300) for r in [jsvc.submit(w, targets) for w in wavs]]
            for a, b in zip(mine, ref):
                assert np.array_equal(a["units"], b["units"])
                assert set(a.get("wavs", {})) == set(b.get("wavs", {}))
                for t in a.get("wavs", {}):
                    assert a["wavs"][t].shape == b["wavs"][t].shape
    finally:
        jsvc.close()


def test_http_server_end_to_end(service):
    httpd, base = _serving(service)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["speakers"] == 2 and h["platform"] == "cpu"
        with urllib.request.urlopen(f"{base}/speakers", timeout=30) as r:
            assert json.loads(r.read())["speakers"] == ["V001", "V002"]
        wav = _wav_body(_tone())
        req = urllib.request.Request(f"{base}/convert?targets=V001&trim=0", data=wav, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        rows = out["units"].splitlines()
        assert rows and set("".join(rows[0].split())) <= {"0", "1"}
        sr, pcm = scipy.io.wavfile.read(io.BytesIO(base64.b64decode(out["wavs"]["V001"])))
        assert sr == 16000 and pcm.dtype == np.int16 and len(pcm) > 0
        # JSON body (raw PCM16 at 8 kHz, resampled), units-only route
        body = json.dumps({"pcm16_b64": base64.b64encode(
            (_tone(n=6000, sr=8000) * 32767).astype(np.int16).tobytes()).decode(), "sr": 8000}).encode()
        req = urllib.request.Request(f"{base}/units?trim=0", data=body,
                                     headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["units"].splitlines()
        # a bad target -> 400 with a message; the server stays up
        req = urllib.request.Request(f"{base}/convert?targets=NOSUCH&trim=0", data=wav, method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400 and "NOSUCH" in json.loads(e.value.read())["error"]
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_units_text_format():
    assert units_text(np.array([[0, 1, 1], [1, 0, 0]], np.int32)) == "0 1 1\n1 0 0"


def test_plan_key_canonicalization(service):
    assert service.plan_key(("V002", "V001", "V002")) == ("V001", "V002")
    with pytest.raises(ValueError):
        service.plan_key(tuple(f"X{i}" for i in range(99)))
    with pytest.raises(KeyError):
        service.plan_key(("V001", "NOSUCH"))


class _Acfg:
    top_db, hop_length = 15.0, 64


def test_solo_batch_failure_is_not_redispatched():
    """A failing single-request batch is its own solo retry: the owner gets
    the original error and the Converter is called once."""
    calls = []

    class _Stub:
        batch_size, stats, acfg = 4, None, _Acfg()

        def encode_units_from_wavs(self, wavs, trim=False):
            calls.append(len(wavs))
            raise ValueError("bad input")

    svc = ConversionService(_Stub(), {"V001": 0}, window_ms=5.0)
    try:
        with pytest.raises(ValueError, match="bad input"):
            svc.convert(np.ones(2048, np.float32), (), trim=False, timeout=30)
        assert calls == [1]
    finally:
        svc.close()


def test_batch_failure_retries_individually():
    """A failed batch falls back to solo runs: the good request succeeds,
    only the bad one's owner sees the error, and no drained key is left."""

    class _Stub:
        batch_size, stats, acfg = 4, None, _Acfg()

        def encode_units_from_wavs(self, wavs, trim=False):
            if len(wavs) > 1:
                raise RuntimeError("batch blew up")
            if len(wavs[0]) == 4096:
                raise RuntimeError("bad input")
            return [np.zeros((3, 8), np.int32)]

    svc = ConversionService(_Stub(), {"V001": 0}, window_ms=150.0)
    try:
        good = svc.submit(np.ones(2048, np.float32), (), trim=False)
        bad = svc.submit(np.ones(4096, np.float32), (), trim=False)
        assert good.result(30)["units"].shape == (3, 8)
        with pytest.raises(RuntimeError, match="bad input"):
            bad.result(30)
        assert svc._queues == {}
    finally:
        svc.close()


def test_bad_first_request_does_not_poison_companions():
    """With the poisoned request first and its failure input-shaped
    (ValueError), the healthy companions are still retried and served."""

    class _Stub:
        batch_size, stats, acfg = 4, None, _Acfg()

        def encode_units_from_wavs(self, wavs, trim=False):
            if any(len(w) == 4096 for w in wavs):
                raise ValueError("bad input")
            return [np.zeros((3, 8), np.int32) for _ in wavs]

    svc = ConversionService(_Stub(), {"V001": 0}, window_ms=150.0)
    try:
        bad = svc.submit(np.ones(4096, np.float32), (), trim=False)
        good1 = svc.submit(np.ones(2048, np.float32), (), trim=False)
        good2 = svc.submit(np.ones(1024, np.float32), (), trim=False)
        with pytest.raises(ValueError, match="bad input"):
            bad.result(30)
        assert good1.result(30)["units"].shape == (3, 8)
        assert good2.result(30)["units"].shape == (3, 8)
    finally:
        svc.close()


def test_submit_rejects_overlong_utterance(service):
    service.max_frames = 16
    try:
        with pytest.raises(ValueError, match="frames"):
            service.submit(_tone(n=16000), ("V001",), trim=False)
    finally:
        service.max_frames = 32768


def test_http_rejects_oversized_body(service):
    httpd, base = _serving(service)
    service.max_body_bytes = 1024
    try:
        req = urllib.request.Request(f"{base}/units?trim=0", data=_wav_body(_tone()), method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 400 and "cap" in json.loads(e.value.read())["error"]
    finally:
        service.max_body_bytes = 64 << 20
        httpd.shutdown()
        httpd.server_close()


def test_warmup_runs_each_bucket_without_dispatches(service):
    """warmup() runs the full conversion and units only once for each
    bucket (rounded up to bucket_frames) through the Converter itself: no
    service dispatch is counted."""
    conv = service.converter
    seen = []
    orig_conv, orig_units = conv.convert_wavs_multi, conv.encode_units_from_wavs

    def spy_conv(wavs, *a, **kw):
        seen.append(("convert", 1 + len(wavs[0]) // conv.acfg.hop_length))
        return orig_conv(wavs, *a, **kw)

    def spy_units(wavs, *a, **kw):
        seen.append(("units", 1 + len(wavs[0]) // conv.acfg.hop_length))
        return orig_units(wavs, *a, **kw)

    d0 = service.dispatches
    conv.convert_wavs_multi, conv.encode_units_from_wavs = spy_conv, spy_units
    try:
        dt = service.warmup([48, 64], n_targets=1)
    finally:
        del conv.convert_wavs_multi, conv.encode_units_from_wavs
    assert dt >= 0.0 and service.dispatches == d0
    assert seen == [("convert", 64), ("units", 64), ("convert", 64), ("units", 64)]


def test_cli_serve_verb(tmp_path, model):
    """``serve --from-export B --port 0 --warmup-buckets 32`` through the
    CLI's own verb, in a thread: it answers /healthz and /convert and a
    micro-batch of concurrent requests, and shutdown ends the call with
    the server and the service closed."""
    h, tree = model
    save_export(tmp_path / "bundle", h, AudioConfig(**ACFG), tree["enc"], tree["dec"], SPEAKERS)
    args = cli.build_parser().parse_args([
        "serve", "--from-export", str(tmp_path / "bundle"), "--port", "0", "--warmup-buckets", "32",
        "--batch-size", "3", "--batch-window-ms", "5000", "--device", "cpu"])
    ready, result = [], {}
    bound = threading.Event()

    def on_serving(httpd, svc):
        ready.append((httpd, svc))
        bound.set()

    th = threading.Thread(target=lambda: result.update(cli.cmd_serve(args, on_serving)), daemon=True)
    th.start()
    assert bound.wait(120)
    httpd, svc = ready[0]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        outs = [None] * 3

        def post(i):
            req = urllib.request.Request(f"{base}/convert?targets=V001&trim=0",
                                         data=_wav_body(_tone(f=200 + 50 * i)), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                outs[i] = json.loads(r.read())

        posts = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for p in posts:  # the batch leaves when its third request arrives (window 5 s)
            p.start()
        for p in posts:
            p.join(120)
        assert all(o is not None and o["units"] for o in outs)
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["served"] == 3 and health["dispatches"] == 1
    finally:
        httpd.shutdown()
    th.join(30)
    assert not th.is_alive() and result == {"dispatches": 1, "served": 3}
