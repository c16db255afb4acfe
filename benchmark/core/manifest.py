"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json``, its traffic in
``traffic/<mix>.json``, the limits of its comparison in
``limits/<cell>.json``, the driver its traffic names in
``drivers/<driver>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, man: dict | None = None) -> dict:
    """The cell ``name`` with its configuration, traffic and limits
    loaded, and the metrics it reports: {"workload", "config", "traffic",
    "limits", "end_to_end": [...], "per_layer": [...]}."""
    man = man or manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}

    e2e = [m for m in man["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {
        "workload": w,
        "config": load_json(ROOT / cfgs[w["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per,
    }


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def reader(metric: str):
    """The ``read(r)`` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
