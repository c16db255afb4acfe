"""Each cell of BENCHMARK.json shrunk to a size the CPU runs in seconds:
the tests' geometry (tests/conftest.py ``tiny_hps``, with speaker
statistics on), a 128-point FFT at hop 16, four Griffin-Lim iterations,
a handful of short utterances, a small arena."""

from __future__ import annotations

import copy

from benchmark.core import manifest

TINY_HPS = dict(batch_size=4, seg_len=32, n_feat=65, emb_size=32, spk_emb_size=8, n_speakers=4,
                bank_size=4, bank_channels=8, conv_channels=16, n_critic=1)
TINY_AUDIO = dict(n_fft=128, hop_length=16, win_length=64, gl_iters=4)
TINY_DURATION = {"median": 0.12, "sigma": 0.5, "min": 0.06, "max": 0.3}
TINY_TRAFFIC = {
    "convert": dict(utterances=5, warm_passes=1, trace_passes=1),
    "train": dict(utterances=40, warm_iters=1, trace_iters=1),
    "serve": dict(rate_per_s=40.0, pool=6, check_sample=4, trace_seconds=0.3, warm_rows=[1, 2]),
}


# The serving cell is kept out of BENCHMARK.json (its tail swung past any
# bound the contract allows: PERF.md, Open questions). Its driver, traffic,
# limits and readers stay, and the tests run it as these entries would.
SERVING = {
    "workload": {"name": "serve-open.lin-f32", "config": "zs19-en-lin-f32", "traffic": "serve-open", "chips": 1,
                 "why": "open-loop Poisson arrivals into ConversionService.submit"},
    "end_to_end": {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
                   "workloads": ["serve-open.lin-f32"]},
    "per_layer": [
        {"name": "idle_share.serve", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "serve_p95_ms", "workloads": ["serve-open.lin-f32"]},
        {"name": "serve.rows_per_dispatch", "unit": "rows/dispatch", "better": "higher", "source": "program_counter",
         "layer": "service", "moves": "serve_p95_ms", "workloads": ["serve-open.lin-f32"]},
    ],
}


def with_serving() -> dict:
    """BENCHMARK.json with the serving cell's entries added."""
    man = manifest.manifest()
    man["workloads"].append(SERVING["workload"])
    man["end_to_end"].append(SERVING["end_to_end"])
    man["per_layer"] += SERVING["per_layer"]
    return man


CELLS = [w["name"] for w in with_serving()["workloads"]]


def tiny_cell(name: str) -> dict:
    c = copy.deepcopy(manifest.cell(name, with_serving()))
    c["config"]["hps"].update(TINY_HPS)
    c["config"]["audio"].update(TINY_AUDIO)
    tr = c["traffic"]
    tr.update(TINY_TRAFFIC[tr["driver"]], duration_s=dict(TINY_DURATION))
    return c
