"""A run end to end on the CPU at the tiny sets (a rehearsal: it writes no
device metric), the control and the planted faults that must come out
not correct, and the refusals of a run without a card or a program."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import ROOT

from gpubench import manifest, run

SEED = 2 ** 31 + 12345


def _run(root, cell, seed=SEED, seconds=0.3, **kw):
    bench = manifest.Bench(root)
    return bench, run.run_cell(bench, cell, seed, seconds, False, "cpu", **kw)


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "g3.gates_b2048", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no result" in out.stderr


def test_run_fails_beside_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    code = ("import sys; sys.path.insert(0, '.'); from pathlib import Path;"
            "from gpubench import manifest, run;"
            "run.run_cell(manifest.Bench(Path('.')), 'g3.gates_b2048', 1, 0.1, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "zig_tfhe_tpu_torch" in out.stderr


@pytest.mark.parametrize("config", ["tiny", "tiny64"])
@pytest.mark.parametrize("mix", ["gates_b2048", "one_lane"])
def test_a_rehearsal_of_each_mix(tiny_root, config, mix):
    bench, r = _run(tiny_root, f"{config}.{mix}", seconds=1.0)
    assert r["correct"] and r["failed"] == 0
    w = r["window"]
    assert r["attempted"] == w.calls * w.lanes == w.calls * bench.traffic(mix)["lanes"]
    for x in bench.end_to_end(f"{config}.{mix}"):
        assert manifest.reader(x["name"])(w) > 0
    line = run.result_line(bench, f"{config}.{mix}", r, False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["device"]["platform"] == "cpu"
    json.dumps(line)


def test_the_window_readers():
    w = run.Window(times=[0.15] * 10, lanes=2048, window_s=1.5, setup_s=9.0)
    assert manifest.reader("bootstraps_per_s")(w) == pytest.approx(2048 * 10 / 1.5)
    assert manifest.reader("setup_s")(w) == 9.0


def test_a_seed_gives_the_same_inputs_and_outputs(tiny_root):
    from gpubench import traffic

    mix = manifest.Bench(tiny_root).traffic("gates_b2048")
    one, two = traffic.draw(mix, SEED), traffic.draw(mix, SEED)
    assert np.array_equal(one.gate_ids, two.gate_ids)
    assert np.array_equal(one.x, two.x) and np.array_equal(one.y, two.y)
    assert not np.array_equal(one.x, traffic.draw(mix, SEED + 1).x)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_comes_out_not_correct(tiny_root, seed):
    """The control: the program with its key one gadget level short on the
    body (the precision below the stated one)."""
    bench = manifest.Bench(tiny_root)
    key = bench.config("tiny")["control_key"]
    _, r = _run(tiny_root, "tiny.gates_b2048", seed=seed, key_form=key)
    assert not r["correct"]
    assert r["check"]["noise_sd"]["value"] > r["check"]["noise_sd"]["limit"]
    _, r = _run(tiny_root, "tiny.gates_b2048", seed=seed)
    assert r["correct"]


def _unchanged_steps(monkeypatch):
    """Every blind-rotation step returns its accumulator unchanged (the mask
    that drives the steps zeroed)."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.blind_rotate

    def broken(tlwe, testvec, ck, params):
        t = tlwe.clone()
        t[..., :params.n0] = 0
        return real(t, testvec, ck, params)

    monkeypatch.setattr(bootstrap, "blind_rotate", broken)


def _half_batch(monkeypatch):
    """Half of the batch left out; its lanes taken from the other half."""
    from zig_tfhe_tpu_torch.models import gates

    real = gates._bootstrap_batch

    def broken(combo, ck, to_lv1=False):
        h = (combo.shape[0] + 1) // 2
        out = real(combo[:h], ck, to_lv1)
        return torch.cat([out, out])[:combo.shape[0]]

    monkeypatch.setattr(gates, "_bootstrap_batch", broken)


def _altered_answer(monkeypatch):
    """One lane's answer negated where the bootstrap produces it."""
    from zig_tfhe_tpu_torch import bootstrap

    real = bootstrap.bootstrap

    def broken(tlwe, ck):
        out = real(tlwe, ck)
        out[0] = -out[0]
        return out

    monkeypatch.setattr(bootstrap, "bootstrap", broken)


@pytest.mark.parametrize("fault", [_unchanged_steps, _half_batch, _altered_answer])
@pytest.mark.parametrize("mix", ["gates_b2048", "one_lane"])
def test_a_planted_fault_comes_out_not_correct(tiny_root, monkeypatch, fault, mix):
    if fault is _half_batch and mix == "one_lane":
        pytest.skip("a one-lane batch has no half to leave out")
    fault(monkeypatch)
    _, r = _run(tiny_root, f"tiny.{mix}")
    assert not r["correct"]
    assert r["failed"] > 0


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "g3.gates_b2048", "--seed", str(SEED), "--seconds", "2",
                          "--trace", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    want = manifest.Bench(ROOT).per_layer("g3.gates_b2048")
    assert set(line["metrics"]) == {x["name"] for x in want}
