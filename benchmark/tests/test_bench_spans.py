"""``core/spans.idle_in`` and the four readers of the conversion stages'
idle shares: exact shares on a hand-built trace, the stages and the rest
summing to ``idle_share``, and nothing read from a CPU run."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.core import manifest, readers, spans
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(1)

STAGES = ("trim", "pack", "launch", "readback")


def _trace(gaps, host, t0=0, t1=1000):
    """A Trace as core/trace.py keeps one, in ns: idle gaps, host ranges."""
    window_s = (t1 - t0) * 1e-9
    idle_s = sum(b - a for a, b in gaps) * 1e-9
    return SimpleNamespace(t0=t0, t1=t1, window_s=window_s, busy_s=window_s - idle_s, gaps=gaps,
                           host=sorted(host))


# device idle in [0, 100), [300, 500), [900, 1000)
GAPS = [(0, 100), (300, 500), (900, 1000)]
HOST = [
    (0, 1000, "convert.convert_wavs_multi"),
    (50, 150, "convert.trim"),  # 50 idle
    (150, 350, "convert.pack"),  # 50 idle
    (200, 260, "aten::zeros"),  # inside pack, all busy
    (350, 450, "convert.launch"),  # 100 idle
    (380, 420, "aten::reflection_pad1d"),  # nested in launch: counted once
    (600, 700, "convert.pack"),  # all busy
    (700, 950, "convert.readback"),  # 50 idle
    (920, 1100, "convert.readback"),  # overlaps the one before, ends past the stretch: with it, 100 idle
]


@pytest.mark.parametrize("stage,idle_ns", [("trim", 50), ("pack", 50), ("launch", 100), ("readback", 100)])
def test_shares_of_a_known_trace(stage, idle_ns):
    t = _trace(GAPS, HOST)
    assert spans.idle_in(t, (f"convert.{stage}",)) == pytest.approx(100.0 * idle_ns / 1000, abs=1e-12)


def test_overlapping_and_nested_ranges_count_once():
    t = _trace(GAPS, HOST)
    assert spans.idle_in(t, ("convert.launch", "aten::reflection_pad1d")) == pytest.approx(10.0, abs=1e-12)
    assert spans.idle_in(t, ("convert.convert_wavs_multi",)) == pytest.approx(40.0, abs=1e-12)
    assert spans.idle_in(t, ("convert.nothing",)) is None


def test_stages_and_the_rest_sum_to_idle_share():
    t = _trace(GAPS, HOST)
    r = SimpleNamespace(trace=t)
    idle = readers.idle_share(r)
    stages = [manifest.reader(f"{s}_idle_share.convert")(r) for s in STAGES]
    # the rest, counted ns by ns: idle and outside every stage span
    inside = [(a, b) for a, b, name in HOST if name in {f"convert.{s}" for s in STAGES}]
    rest = sum(1 for ns in range(t.t0, t.t1)
               if any(a <= ns < b for a, b in GAPS) and not any(a <= ns < b for a, b in inside))
    assert sum(stages) + 100.0 * rest / 1000 == pytest.approx(idle, abs=1e-9)
    assert idle == pytest.approx(40.0, abs=1e-9)


def test_nothing_to_read_without_a_busy_device():
    assert spans.idle_in(None, ("convert.trim",)) is None
    assert spans.idle_in(_trace([(0, 1000)], HOST), ("convert.trim",)) is None


def test_a_traced_cpu_run_leaves_the_stage_shares_out():
    name = "convert-corpus.lin-f32"
    res = run.run(name, 2**31 + 11, 0.2, True, "cpu", tiny_cell(name))
    assert res["correct"]
    assert not {f"{s}_idle_share.convert" for s in STAGES} & set(res["metrics"])
