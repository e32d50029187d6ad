"""BENCHMARK.json against the contract, and discovery by name."""

import copy
import json

import pytest
from conftest import ROOT

from gpubench import manifest


def _real():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_meets_the_contract():
    manifest.validate(_real())


def test_every_named_piece_is_a_file_of_its_own():
    bench = manifest.Bench(ROOT)
    m = bench.m
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert all(k in bench.config(c["name"]) for k in ("params", "key", "limits"))
    for w in m["workloads"]:
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").is_file()
    for x in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(x["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    bench = manifest.Bench(ROOT)
    for w in bench.m["workloads"]:
        e2e = {x["name"] for x in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.per_layer(w["name"])


@pytest.mark.parametrize("edit, what", [
    (lambda m: m["workloads"][0].update(name="has space"), "not a name"),
    (lambda m: m["workloads"][0].update(extra=1), "workload keys"),
    (lambda m: m["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda m: m["end_to_end"][0].update(unit="tokens per s"), "unit"),
    (lambda m: m["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda m: m["workloads"].append(dict(m["workloads"][0], name="x")),
     "repeated"),
    (lambda m: m["configs"].append(dict(m["configs"][0], name="unused")),
     "no cell uses"),
    (lambda m: m.update(run_seconds=60), "run_seconds"),
])
def test_a_manifest_that_breaks_the_contract_is_refused(edit, what):
    m = copy.deepcopy(_real())
    edit(m)
    with pytest.raises(manifest.ManifestError, match=what):
        manifest.validate(m)


def test_a_configuration_and_cells_added_as_data_are_picked_up(tiny_root):
    bench = manifest.Bench(tiny_root)
    assert bench.config("tiny")["params"] == "tiny"
    assert bench.cell("tiny.gates_b2048")["config"] == "tiny"
    assert bench.traffic(bench.cell("tiny64.one_lane")["traffic"])["lanes"] == 1
    # a metric without a ``workloads`` list reaches every cell
    assert [x["name"] for x in bench.end_to_end("tiny.one_lane")] == ["setup_s"]


def test_a_per_layer_metric_without_a_list_reaches_the_cells_of_its_metric(tiny_root):
    path = tiny_root / "BENCHMARK.json"
    m = json.loads(path.read_text())
    m["per_layer"].append({"name": "x", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device",
                           "moves": "bootstraps_per_s"})
    path.write_text(json.dumps(m))
    bench = manifest.Bench(tiny_root)
    assert "x" in [x["name"] for x in bench.per_layer("g3.gates_b2048")]
    assert "x" not in [x["name"] for x in bench.per_layer("tiny.one_lane")]
