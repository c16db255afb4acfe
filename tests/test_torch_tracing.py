"""PyTorch port, tracing: the spans of tracing.py inside the Converter, the
Solver and the ConversionService, recorded only while a ``torch.profiler``
profile runs, and the collector's ``python.gc`` ranges."""

import gc
import importlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

from zerospeech_tts_tpu_torch import cli, tracing
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.convert import Converter, _bucket_stats
from zerospeech_tts_tpu_torch.dsp.audio import n_frames_for
from zerospeech_tts_tpu_torch.dsp.wavio import trim_silence
from zerospeech_tts_tpu_torch.export import save_export
from zerospeech_tts_tpu_torch.params import from_flax, init_params
from zerospeech_tts_tpu_torch.serve import ConversionService, serve_http
from zerospeech_tts_tpu_torch.tools import serve_pauses
from zerospeech_tts_tpu_torch.train.solver import Solver, init_state

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
STAGES = ("convert.trim", "convert.pack", "convert.launch", "convert.readback")


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = sum(0.25 / k * np.sin(2 * np.pi * k * (140 + 40 * seed) * t) for k in range(1, 6))
    y = np.concatenate([np.zeros(400), y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t)), np.zeros(400)])
    return (y + 0.02 * rng.standard_normal(len(y))).astype(np.float32)


# several buckets at bucket_frames 32, one of them two dispatches at batch 2
WAVS = [_speechlike(n, s) for s, n in enumerate((4032, 3000, 1500, 1400, 1300))]


@pytest.fixture(scope="module")
def conv():
    h = Hps(speaker_norm=False, n_feat=129, emb_size=16, spk_emb_size=4, n_speakers=2,
            bank_size=2, bank_channels=4, conv_channels=8)
    return Converter(h, AudioConfig(**ACFG), *from_flax(init_params(h)), batch_size=2, bucket_frames=32,
                     device="cpu")


def _ranges(prof, names=None):
    """[(start_ns, end_ns, name, thread)] of the profile's host ranges, by start."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and (names is None or e.name in names):
            out.append((int(e.time_range.start * 1000), int(e.time_range.end * 1000), e.name, e.thread))
    return sorted(out)


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_is_one_shared_noop_without_a_profile():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("convert.trim"), tracing.span("serve.dispatch")
    assert a is b is tracing.NULL
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("inside"):
            pass
    assert tracing.span("after") is tracing.NULL
    assert [r[2] for r in _ranges(prof, {"inside", "after"})] == ["inside"]


def test_convert_wavs_multi_spans(conv):
    frames = [n_frames_for(len(trim_silence(w, conv.acfg.top_db)), conv.acfg) for w in WAVS]
    n_disp = _bucket_stats(conv, frames)["n_dispatches"]
    assert n_disp >= 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        conv.convert_wavs_multi(WAVS, [0, 1])
    rs = _ranges(prof)
    (entry,) = [r for r in rs if r[2] == "convert.convert_wavs_multi"]
    stages = [r for r in rs if r[2] in STAGES]
    assert [r[2] for r in stages] == ["convert.trim"] + ["convert.pack", "convert.launch"] * n_disp \
        + ["convert.readback"] * n_disp
    assert all(_inside(s, entry) for s in stages)
    for a, b in zip(stages, stages[1:]):  # none inside another: they follow one another
        assert a[1] <= b[0]
    launches = [s for s in stages if s[2] == "convert.launch"]
    frontend = [r for r in rs if r[2] == "aten::reflection_pad1d"]
    assert frontend and all(any(_inside(f, s) for s in launches) for f in frontend)


def test_units_and_pcm_are_bit_equal_under_a_profile(conv):
    plain = conv.convert_wavs_multi(WAVS, [0, 1])
    with profile(activities=[ProfilerActivity.CPU]):
        traced = conv.convert_wavs_multi(WAVS, [0, 1])
    for a, b in zip(plain[0], traced[0]):
        assert np.array_equal(a, b)
    for pa, pb in zip(plain[1], traced[1]):
        for a, b in zip(pa, pb):
            assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b)


def test_unit_entries_have_their_spans(conv):
    feats = [np.random.default_rng(i).uniform(0, 1, (40 + 9 * i, 129)).astype(np.float32) for i in range(3)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        conv.encode_units_from_wavs(WAVS[:2])
        conv.encode_units(feats)
        conv.convert_features_multi(feats, [1])
    names = [r[2] for r in _ranges(prof)]
    for entry in ("convert.encode_units_from_wavs", "convert.encode_units", "convert.convert_features_multi"):
        assert names.count(entry) == 1
    assert names.count("convert.trim") == 1  # the wav route alone trims


def test_patchgan_iteration_spans(tiny_hps):
    h = tiny_hps.replace(n_critic=2)
    state = init_state(h, seed=0, device="cpu")
    rng = np.random.default_rng(0)

    def batches():
        while True:
            f = lambda: torch.from_numpy(rng.uniform(0, 1, (h.batch_size, h.seg_len, h.n_feat)).astype(np.float32))  # noqa: E731
            ids = lambda: torch.from_numpy(rng.integers(0, h.n_speakers, h.batch_size))  # noqa: E731
            yield {"x": f(), "spk": ids(), "x_real": f(), "spk_real": ids()}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Solver(h).train(state, batches(), "patchGAN", 1)
    rs = _ranges(prof, {"solver.sample", "solver.forward", "solver.backward", "solver.update",
                        "solver.penalty_grad"})
    count = lambda n: sum(r[2] == n for r in rs)  # noqa: E731
    for n in ("solver.sample", "solver.forward", "solver.backward", "solver.update"):
        assert count(n) == h.n_critic + 1, n
    forwards = [r for r in rs if r[2] == "solver.forward"]
    penalties = [r for r in rs if r[2] == "solver.penalty_grad"]
    assert len(penalties) == h.n_critic
    # the critic steps come first; the generator step's forward holds no penalty
    assert all(any(_inside(p, f) for f in forwards[: h.n_critic]) for p in penalties)
    assert not any(_inside(p, forwards[-1]) for p in penalties)


def test_service_counters_spans_and_healthz(conv):
    svc = ConversionService(conv, {"V001": 0, "V002": 1}, window_ms=50.0, max_batch=2)
    try:
        all_threads = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=[ProfilerActivity.CPU], experimental_config=all_threads) as prof:
            with svc._cv:  # two requests of one key: one batch
                reqs = [svc.submit(w, ("V001",), trim=False) for w in WAVS[:2]]
            for r in reqs:
                r.result(timeout=300)
            svc.convert(WAVS[2], (), trim=False)
        assert svc.dispatches == 2 and svc.served == 3
        assert svc.queue_wait_s >= 0 and svc.window_wait_s > 0 and svc.dispatch_s > 0
        assert svc.window_s == 0.05  # the window's length, as the JAX package's service has it
        main = threading.get_native_id()
        dispatch = _ranges(prof, {"serve.dispatch"})
        assert len(dispatch) == 2 and all(r[3] != main for r in dispatch)  # on the worker
        windows = _ranges(prof, {"serve.window"})
        assert len(windows) >= 2 and all(r[3] == dispatch[0][3] for r in windows + dispatch)
        # a batch's window closes before its dispatch opens
        assert all(any(w[1] <= d[0] for w in windows) for d in dispatch)
        httpd = serve_http(svc, host="127.0.0.1", port=0)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{httpd.server_address[1]}/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            httpd.shutdown()
            httpd.server_close()
        t.join(30)
        assert not t.is_alive()
        for k in ("queue_wait_s", "window_wait_s", "dispatch_s"):
            assert health[k] == getattr(svc, k)
    finally:
        svc.close()


def test_gc_range_only_under_a_profile_and_one_hook():
    hooks = [cb for cb in gc.callbacks if getattr(cb, "zs_tracing", False)]
    importlib.reload(tracing)
    importlib.import_module("zerospeech_tts_tpu_torch.tracing")
    assert len([cb for cb in gc.callbacks if getattr(cb, "zs_tracing", False)]) == len(hooks) == 1
    gc.disable()  # the collections below are the test's own
    try:
        gc.collect()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gc.collect()
        with profile(activities=[ProfilerActivity.CPU]) as idle:
            pass
        gc.collect()  # no profile: records nothing, opens nothing
    finally:
        gc.enable()
    assert [r[2] for r in _ranges(prof, {"python.gc"})] == ["python.gc"]
    assert not _ranges(idle, {"python.gc"})
    assert getattr(tracing._open, "rf", None) is None


def _chrome(path, spans):
    """A Chrome trace of user ranges [(name, tid, start_us, dur_us)]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": t, "ts": a, "dur": d}
          for n, t, a, d in spans]
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "python.gc", "pid": 0, "tid": 7,
               "ts": 0, "dur": 10_000_000})  # the device's copy of a range: not read
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_serve_pauses_splits_a_built_trace(tmp_path):
    trace = _chrome(tmp_path / "serve.pt.trace.json", [
        ("serve.window", 2, 0, 5_000), ("serve.dispatch", 2, 5_000, 200_000),
        ("serve.window", 2, 205_000, 5_000), ("serve.dispatch", 2, 210_000, 40_000),
        # 150 ms: 100 in the first dispatch, 5 in the window, 40 in the second, 5 in neither
        ("python.gc", 3, 105_000, 150_000),
        ("python.gc", 2, 300_000, 2_000),  # short: counted, not listed
        ("convert.launch", 2, 6_000, 1_000),
    ])
    out = serve_pauses.main([str(trace), "--over-ms", "100"])
    assert out["gc"]["count"] == 2 and out["gc"]["total_ms"] == 152.0 and out["gc"]["max_ms"] == 150.0
    assert out["gc_over"] == [{"ms": 150.0, "dispatch_ms": 140.0, "window_ms": 5.0, "none_ms": 5.0}]
    assert out["dispatch"]["count"] == 2 and out["dispatch"]["gc_ms"] == 140.0
    assert out["window"]["count"] == 2 and out["window"]["gc_ms"] == 5.0
    assert out["dispatch_over"] == [{"ms": 200.0, "gc_ms": 100.0}]
    assert serve_pauses.union([(5, 6), (0, 2), (1, 3)]) == [(0, 3), (5, 6)]


def test_cli_serve_profile_records_every_thread(tmp_path, tiny_hps):
    """``serve --profile DIR`` writes DIR/serve.pt.trace.json at shutdown with
    the worker's spans and another thread's collection in it, and
    tools/serve_pauses reads them."""
    h = tiny_hps.replace(n_feat=129)
    tree = init_params(h, seed=0)
    save_export(tmp_path / "bundle", h, AudioConfig(**ACFG), tree["enc"], tree["dec"], {"V001": 0, "V002": 1})
    args = cli.build_parser().parse_args([
        "serve", "--from-export", str(tmp_path / "bundle"), "--port", "0", "--batch-size", "2",
        "--device", "cpu", "--profile", str(tmp_path / "prof")])
    ready, result = [], {}
    bound = threading.Event()

    def on_serving(httpd, svc):
        ready.append((httpd, svc))
        bound.set()

    th = threading.Thread(target=lambda: result.update(cli.cmd_serve(args, on_serving)), daemon=True)
    th.start()
    assert bound.wait(120)
    httpd, svc = ready[0]
    try:
        svc.convert(WAVS[2], ("V001",), trim=False)
        svc.convert(WAVS[3], (), trim=False)
        gc.collect()  # on this thread, while the profile runs
    finally:
        httpd.shutdown()
    th.join(120)
    assert not th.is_alive() and result == {"dispatches": 2, "served": 2}
    trace = tmp_path / "prof" / "serve.pt.trace.json"
    ranges = serve_pauses.load(trace)
    assert len(ranges["serve.dispatch"]) == 2 and len(ranges["serve.window"]) >= 2
    assert ranges["python.gc"]
    out = serve_pauses.main([str(trace), "--over-ms", "0"])
    assert out["dispatch"]["count"] == 2 and len(out["gc_over"]) == out["gc"]["count"] >= 1
    for g in out["gc_over"]:
        assert g["dispatch_ms"] >= 0 and g["window_ms"] >= 0 and g["none_ms"] >= -1e-9
        assert abs(g["dispatch_ms"] + g["window_ms"] + g["none_ms"] - g["ms"]) < 1e-9
