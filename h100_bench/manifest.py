"""``BENCHMARK.json``: load, validate, and find each name's files.

Every cell, configuration, traffic mix, metric and span lives in a file of
its own under this folder and is found by its name: a later cell, metric or
traffic mix is added by adding files and entries, never by editing one.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


class ManifestError(ValueError):
    pass


def _line(s, what: str) -> None:
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, got {s!r}")


def _name(s, what: str) -> None:
    if not isinstance(s, str) or not NAME.fullmatch(s):
        raise ManifestError(f"{what}: not a name: {s!r}")


def _keys(entry: dict, required: set, optional: set, what: str) -> None:
    have = set(entry)
    if not required <= have or have - required - optional:
        raise ManifestError(f"{what}: keys {sorted(have)}, want {sorted(required)} (+ {sorted(optional)})")


def validate(doc: dict, root: Path | None = None) -> None:
    """Raise :class:`ManifestError` where ``doc`` breaks the benchmark's rules
    (names, units, sources, cells, the metrics each cell reports); with
    ``root``, also where a configuration's file is missing."""
    if set(doc) != KEYS:
        raise ManifestError(f"keys {sorted(doc)}, want {sorted(KEYS)}")
    if not isinstance(doc["command"], list) or not 1 <= len(doc["command"]) <= 32:
        raise ManifestError("command: a list of 1 to 32 strings")
    for w in doc["command"]:
        _line(w, "command")
    if not 1 <= len(doc["paths"]) <= 16:
        raise ManifestError("paths: 1 to 16 directories")
    for p in doc["paths"]:
        if not re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) or p.startswith("/") or ".." in p.split("/"):
            raise ManifestError(f"paths: {p!r}")
    if not isinstance(doc["run_seconds"], int) or not 1 <= doc["run_seconds"] <= 51:
        raise ManifestError("run_seconds: a whole number from 1 to 51")
    configs = doc["configs"]
    if not 1 <= len(configs) <= 24:
        raise ManifestError("configs: 1 to 24")
    names = set()
    for c in configs:
        _keys(c, {"name", "source", "file", "reduced", "why"}, set(), f"config {c.get('name')}")
        _name(c["name"], "config name")
        _line(c["source"], "source")
        _line(c["why"], "why")
        if len(c["reduced"]) > 16:
            raise ManifestError(f"config {c['name']}: more than 16 reduced keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in doc["paths"]):
            raise ManifestError(f"config {c['name']}: file {c['file']} outside paths")
        if root is not None and not (root / c["file"]).is_file():
            raise ManifestError(f"config {c['name']}: no file {c['file']}")
        names.add(c["name"])
    if len(names) != len(configs) or len({c["file"] for c in configs}) != len(configs):
        raise ManifestError("configs: a name or a file twice")
    cells = doc["workloads"]
    if not 1 <= len(cells) <= 24:
        raise ManifestError("workloads: 1 to 24 cells")
    pairs, cell_names = set(), set()
    for w in cells:
        _keys(w, {"name", "config", "traffic", "chips", "why"}, set(), f"workload {w.get('name')}")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], "why")
        if w["config"] not in names:
            raise ManifestError(f"workload {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips {w['chips']}")
        pairs.add((w["config"], w["traffic"]))
        cell_names.add(w["name"])
    if len(pairs) != len(cells) or len(cell_names) != len(cells):
        raise ManifestError("workloads: a name or a (config, traffic) pair twice")
    if sum(w["chips"] == 4 for w in cells) > max(1, len(cells) // 4):
        raise ManifestError("workloads: more than 25% of the cells on four chips")
    if {c["name"] for c in configs} - {w["config"] for w in cells}:
        raise ManifestError("configs: one is used by no cell")
    e2e, per_layer = doc["end_to_end"], doc["per_layer"]
    if not 1 <= len(e2e) <= 16 or not 1 <= len(per_layer) <= 128:
        raise ManifestError("end_to_end: 1 to 16 metrics, per_layer: 1 to 128")
    metric_names = set()
    for m in e2e + per_layer:
        is_e2e = any(m is x for x in e2e)
        req = {"name", "unit", "better", "source"} | ({"bound"} if is_e2e else {"layer", "moves"})
        _keys(m, req, {"workloads"}, f"metric {m.get('name')}")
        _name(m["name"], "metric name")
        if not UNIT.fullmatch(m["unit"]):
            raise ManifestError(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ManifestError(f"metric {m['name']}: better {m['better']!r}")
        if m["source"] not in (SOURCES_E2E if is_e2e else SOURCES):
            raise ManifestError(f"metric {m['name']}: source {m['source']!r}")
        for w in m.get("workloads", []):
            if w not in cell_names:
                raise ManifestError(f"metric {m['name']}: unknown workload {w}")
        if is_e2e and not 0.01 <= m["bound"] <= 0.25:
            raise ManifestError(f"metric {m['name']}: bound {m['bound']} outside [0.01, 0.25]")
        if not is_e2e:
            _line(m["layer"], "layer")
        metric_names.add(m["name"])
    if len(metric_names) != len(e2e) + len(per_layer):
        raise ManifestError("metrics: a name twice")
    if "setup_s" not in {m["name"] for m in e2e}:
        raise ManifestError("end_to_end: no setup_s")
    bench = Benchmark(doc)
    for w in cells:
        have = {m["name"] for m in bench.metrics(w["name"], trace=False)}
        if "setup_s" not in have or len(have) < 2:
            raise ManifestError(f"workload {w['name']}: setup_s and another end-to-end metric, got {sorted(have)}")
        if not bench.metrics(w["name"], trace=True):
            raise ManifestError(f"workload {w['name']}: no per-layer metric")
    for m in per_layer:
        moved = [x for x in e2e if x["name"] == m["moves"]]
        if not moved:
            raise ManifestError(f"metric {m['name']}: moves unknown {m['moves']}")
        for w in m.get("workloads", list(cell_names)):
            if not any(x["name"] == m["moves"] for x in bench.metrics(w, trace=False)):
                raise ManifestError(f"metric {m['name']}: {w} does not report {m['moves']}")


@dataclass
class Benchmark:
    doc: dict

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise ManifestError(f"no workload {name!r}; have {[w['name'] for w in self.doc['workloads']]}")

    def config_entry(self, name: str) -> dict:
        return next(c for c in self.doc["configs"] if c["name"] == name)

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of ``workload`` reports: its end-to-end metrics,
        or with ``trace`` its per-layer ones."""
        group = self.doc["per_layer"] if trace else self.doc["end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]


def load(path: Path) -> Benchmark:
    doc = json.loads(Path(path).read_text())
    validate(doc, Path(path).parent)
    return Benchmark(doc)


def read_json(kind: str, name: str, base: Path = HERE) -> dict:
    """``<base>/<kind>/<name>.json``."""
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise ManifestError(f"no {kind} file {path}")
    return json.loads(path.read_text())
