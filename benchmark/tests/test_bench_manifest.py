"""BENCHMARK.json against the benchmark's contract: names, units and
keys; every metric's ``moves`` reported where the metric is; every cell's
files found by name; the check's budget at the chosen ``run_seconds``."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from benchmark.core import manifest

MAN = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|emb|channels|feat|expan")


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == KEYS["top"]
    assert (manifest.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_just_their_keys_and_names(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and section != "end_to_end" and section != "per_layer":
                assert _text_ok(e[k]), (e["name"], k)
        if "layer" in e:
            assert _text_ok(e["layer"])


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_command_and_paths():
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(_text_ok(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.endswith("_torch")
        assert (manifest.ROOT / p).is_dir()


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_reported_metric_and_have_readers():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e, m["name"]
        moved = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert w in moved.get("workloads", [w]), (m["name"], w)
        assert (manifest.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_layers_name_the_same_layer_alike():
    perf = (manifest.ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MAN["per_layer"]}:
        assert f"| {layer} |" in perf, layer


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files_and_reports_enough(w):
    c = manifest.cell(w)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    assert (manifest.HERE / "drivers" / f"{c['traffic']['driver']}.py").is_file()
    cell = next(x for x in MAN["workloads"] if x["name"] == w)
    assert cell["chips"] in (1, 4) and _text_ok(cell["why"])
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())


def test_configs_files_reduced_and_sources():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert Path(manifest.ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://") and _text_ok(c["source"])
        assert len(c["reduced"]) <= 16 and not any(WIDTH.search(k) for k in c["reduced"])
        assert manifest.load_json(manifest.ROOT / c["file"])["reduced"] == c["reduced"]


def test_configuration_and_traffic_pairs_are_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_check_fits_its_budget_with_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (manifest.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(manifest.ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
