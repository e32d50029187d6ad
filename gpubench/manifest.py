"""``BENCHMARK.json`` and the data files it names.

Every piece is found by name, so that a later change adds a configuration,
a traffic mix, a traffic kind, a cell or a per-layer metric by adding files
and entries:

* a configuration's sizes: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``gpubench/traffic/<traffic>.json``, the parameters that
  the one generator in ``traffic.py`` reads, its ``kind`` among them;
* a traffic kind: ``gpubench/kinds/<kind>.py``, with ``draw(mix, seed)``,
  the program adapter ``Program``, ``judge``, ``WRONG`` (the name of its
  count of wrong lanes), ``CALL_SPAN`` (the outermost span of one call)
  and ``ENQUEUE`` (the host span of a call's enqueue);
* a per-layer metric: ``gpubench/metrics/<name>.py``, a reader with
  ``read(trace) -> float | None``;
* a cell: an entry of ``workloads``.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRICS_DIR = HERE / "metrics"
KINDS_DIR = HERE / "kinds"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES_E2E = ("host_clock", "device_trace")
# the contract's two program sources have no metric yet; they are accepted
# so that a later change adds such a metric as an entry and a reader alone
SOURCES = SOURCES_E2E + ("program_span", "program_counter")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


class ManifestError(ValueError):
    pass


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise ManifestError(what)


def _line(text, what: str) -> None:
    _need(isinstance(text, str) and 1 <= len(text) <= 200
          and "\n" not in text and "\t" not in text,
          f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what: str) -> None:
    _need(isinstance(text, str) and NAME.fullmatch(text) is not None,
          f"{what}: {text!r} is not a name")


def validate(m: dict) -> None:
    """Raise ManifestError where ``m`` breaks the benchmark's contract."""
    _need(set(m) == KEYS["top"], f"top-level keys {sorted(m)}")
    _need(1 <= len(m["configs"]) <= 24, "1 to 24 configs")
    _need(1 <= len(m["workloads"]) <= 24, "1 to 24 workloads")
    _need(1 <= len(m["end_to_end"]) <= 16, "1 to 16 end-to-end metrics")
    _need(1 <= len(m["per_layer"]) <= 128, "1 to 128 per-layer metrics")
    _need(isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51,
          "run_seconds a whole number from 1 to 51")
    for c in m["configs"]:
        _need(set(c) == KEYS["config"], f"config keys {sorted(c)}")
        _name(c["name"], "config")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        _need(len(c["reduced"]) <= 16, "reduced: at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    for w in m["workloads"]:
        _need(set(w) == KEYS["workload"], f"workload keys {sorted(w)}")
        _name(w["name"], "workload")
        _name(w["traffic"], "traffic")
        _line(w["why"], "workload why")
        _need(w["config"] in configs, f"{w['name']}: no config {w['config']}")
        _need(w["chips"] in (1, 4), f"{w['name']}: chips 1 or 4")
        pair = (w["config"], w["traffic"])
        _need(pair not in pairs, f"{w['name']}: config and traffic repeated")
        pairs.add(pair)
    cells = {w["name"] for w in m["workloads"]}
    _need(len(cells) == len(m["workloads"]), "workload names repeated")
    _need(len(configs) == len(m["configs"]), "config names repeated")
    used = {w["config"] for w in m["workloads"]}
    _need(used == configs, f"configs no cell uses: {sorted(configs - used)}")
    names = set()
    for part in ("end_to_end", "per_layer"):
        for x in m[part]:
            _need(set(x) - {"workloads"} == KEYS[part],
                  f"{part} metric keys {sorted(x)}")
            _name(x["name"], "metric")
            _need(x["name"] not in names, f"metric {x['name']} repeated")
            names.add(x["name"])
            _need(UNIT.fullmatch(x["unit"]) is not None,
                  f"{x['name']}: unit {x['unit']!r}")
            _need(x["better"] in ("lower", "higher"), f"{x['name']}: better")
            _need(x["source"] in (SOURCES_E2E if part == "end_to_end"
                                  else SOURCES), f"{x['name']}: source")
            for cell in x.get("workloads", ()):
                _need(cell in cells, f"{x['name']}: no cell {cell}")
    e2e = {x["name"] for x in m["end_to_end"]}
    _need("setup_s" in e2e, "setup_s is an end-to-end metric")
    for x in m["end_to_end"]:
        _need(isinstance(x["bound"], (int, float))
              and 0.01 <= x["bound"] <= 0.25, f"{x['name']}: bound")
    for x in m["per_layer"]:
        _line(x["layer"], f"{x['name']} layer")
        _need(x["moves"] in e2e, f"{x['name']}: moves {x['moves']}")


class Bench:
    """A manifest and the files it names, relative to ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.m = json.loads((self.root / "BENCHMARK.json").read_text())
        validate(self.m)

    def cell(self, name: str) -> dict:
        for w in self.m["workloads"]:
            if w["name"] == name:
                return w
        raise ManifestError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.m["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        path = self.root / "gpubench" / "traffic" / f"{name}.json"
        return json.loads(path.read_text())

    def end_to_end(self, cell: str) -> list:
        return [x for x in self.m["end_to_end"]
                if cell in x.get("workloads", (cell,))]

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics a traced run of ``cell`` reports: those that
        list it, and those without a list whose end-to-end metric it
        reports."""
        e2e = {x["name"] for x in self.end_to_end(cell)}
        return [x for x in self.m["per_layer"]
                if (cell in x["workloads"] if "workloads" in x
                    else x["moves"] in e2e)]


def _load(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _load(METRICS_DIR / f"{metric}.py", "gpubench_metric_", metric).read


@functools.cache
def kind(name: str):
    """The module ``kinds/<name>.py`` of a traffic kind (loaded once)."""
    if not isinstance(name, str) or NAME.fullmatch(name) is None \
            or not (KINDS_DIR / f"{name}.py").is_file():
        have = sorted(p.stem for p in KINDS_DIR.glob("*.py"))
        raise ValueError(f"traffic kind {name!r}: the generator draws {have}")
    return _load(KINDS_DIR / f"{name}.py", "gpubench_kind_", name)
