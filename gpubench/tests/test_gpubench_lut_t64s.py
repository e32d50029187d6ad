"""The cell ``t64s.lut_b2048``: tfhe-rs's shortint PBS on its default key
(``configs/t64s.json``) under the LUT mix, the metrics it reports, its
plain reference (``reference/pbs64.py``) and a rehearsal of its readers
on a tiny split-ring LUT configuration defined here."""

import json
import shutil
import time

import numpy as np
import pytest
import torch
from conftest import ROOT

from gpubench import manifest, run, trace, traffic
from gpubench.manifest import Bench, reader
from zig_tfhe_tpu_torch.utils import profiling

CELL = "t64s.lut_b2048"
SEED = 2 ** 33 + 26
# the metrics the cell reports, in BENCHMARK.json's order
PER_LAYER = ["idle_share.batch", "k1_roofline", "glue_us_per_step",
             "idle_ms_per_call.prelude", "idle_ms_per_call.steps",
             "idle_ms_per_call.finish", "key_switch_ms_per_call",
             "host_syncs_per_call", "k2s_roofline", "k2s_steps_per_call",
             "testvec_ms_per_call"]
# TEST_TINY_SPLIT (N = 2048 on the split ring, n0 = 8, noise-free
# encryptions) at its default key: group 2, Bg_e 2^8 with (2, 2) levels,
# drop 32 (the hi-plane scan), 4 primes; the CPU runs a call of it in
# about a second
TINY_SPLIT = {
    "params": "tiny_split", "deployment": "test", "torus_bits": 64, "n0": 8,
    "N": 2048, "lwe_alpha": 0.0, "glwe_alpha": 0.0, "bg_bits": 8,
    "levels": 2, "ks_base_bits": 4, "ks_levels": 6, "split_ring": True,
    "key": {"group": 2, "engine_bgbit": 8, "decomp_levels": [2, 2]},
    "drop": 32, "n_primes": 4,
    "control_key": {"group": 2, "engine_bgbit": 8, "decomp_levels": [2, 1]},
    "limits": {"noise_sd": 0.003}}
# a programmable bootstrap a lane on Z_16, every function of the reference
LUT_M16 = {"kind": "lut", "lanes": 16, "message_modulus": 16,
           "functions": "all", "pool": 2, "warm_calls": 1, "trace_calls": 2}


@pytest.fixture
def split_root(tmp_path):
    """A checkout whose benchmark has gained, as data only, the
    configuration ``tiny_split``, the mix ``lut_m16`` and their cell."""
    shutil.copytree(ROOT / "gpubench" / "traffic", tmp_path / "gpubench" / "traffic")
    (tmp_path / "gpubench" / "traffic" / "lut_m16.json").write_text(
        json.dumps(LUT_M16))
    (tmp_path / "gpubench" / "configs").mkdir()
    f = "gpubench/configs/tiny_split.json"
    (tmp_path / f).write_text(json.dumps(TINY_SPLIT))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_split", "source": "test", "file": f,
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny_split.lut_m16", "config": "tiny_split",
                           "traffic": "lut_m16", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path


def test_the_cell_reports_its_metrics():
    bench = Bench(ROOT)
    cell = bench.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("t64s",
                                                                "lut_b2048", 1)
    assert [x["name"] for x in bench.per_layer(CELL)] == PER_LAYER
    assert [x["name"] for x in bench.end_to_end(CELL)] == ["bootstraps_per_s",
                                                           "setup_s"]
    # the accepted cells read what they read before
    for x in bench.m["per_layer"]:
        if "workloads" in x:
            assert (CELL in x["workloads"]) == (x["name"] in PER_LAYER)
            assert x["workloads"][-1] == CELL or CELL not in x["workloads"]


def test_the_configuration_is_the_ports_tfhers_2_2_set():
    from zig_tfhe_tpu_torch import params

    bench = Bench(ROOT)
    cfg = bench.config("t64s")
    p = params.PARAMS_BY_NAME[cfg["params"]]
    assert p is params.SECURITY_TFHERS_2_2
    assert (p.torus_bits, p.n0, p.N, p.tlwe_lv0.alpha, p.tlwe_lv1.alpha,
            p.bgbit, p.L, p.basebit, p.iks_t, p.split_ring) == tuple(
        cfg[k] for k in ("torus_bits", "n0", "N", "lwe_alpha", "glwe_alpha",
                         "bg_bits", "levels", "ks_base_bits", "ks_levels",
                         "split_ring"))
    # the gate server's key form and control, under the block codec
    t64 = bench.config("t64")
    assert {k: cfg[k] for k in ("key", "drop", "n_primes", "control_key")} == {
        k: t64[k] for k in ("key", "drop", "n_primes", "control_key")}
    assert cfg["assumed"][0] == t64["assumed"][0]
    mix = traffic.draw(bench.traffic("lut_b2048"), SEED)
    # the codec's scale 1/(2m) at m = 16 is tfhe-rs's delta 2^59 with the
    # padding bit: 2^64 / 32
    assert (mix.lanes, mix.message_modulus, len(mix.functions)) == (2048, 16, 7)
    assert 2 ** cfg["torus_bits"] // (2 * mix.message_modulus) == 2 ** 59


def test_loading_the_64_bit_pbs_reference_loads_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import gpubench.reference.pbs64;"
            "from gpubench import importcheck as c;"
            "print(c.refused(sys.modules, c.REFUSED_IN_REFERENCE))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def _recorded_calls(root, cell):
    bench = manifest.Bench(root)
    cfg = bench.config(bench.cell(cell)["config"])
    mix_params = bench.traffic(bench.cell(cell)["traffic"])
    kind = manifest.kind(mix_params["kind"])
    prog = kind.Program(cfg, SEED, "cpu")
    mix = traffic.draw(mix_params, SEED)
    pool = prog.encrypt(mix)
    profiling.clear()
    try:
        with profiling.recording():
            t0 = time.time_ns()
            outs = [prog.apply(pool, k).numpy() for k in (0, 1)]
            t1 = time.time_ns()
        t = trace.Trace(records=[], launched={}, host_spans=[("call", t0, t1)],
                        calls=2, window_ns=t1 - t0, cfg=cfg, lanes=mix.lanes,
                        call_span=kind.CALL_SPAN)
        judged = kind.judge(np.concatenate(outs), prog.key_lv0, cfg, mix, 2)
        read = {m: reader(m)(t) for m in ("testvec_ms_per_call",
                                          "plain_digit_steps_per_call",
                                          "k2s_steps_per_call")}
        return t, prog, profiling.spans(), judged, read
    finally:
        profiling.clear()


def test_a_rehearsal_of_the_cells_readers(split_root):
    """Two calls of a split-ring LUT cell recorded on the CPU: each call's
    ``lut.call`` holds one ``blind_rotate.testvec`` span, under
    ``lut.apply``, closed before the call's steps open; off a card the
    span is not placed, so ``testvec_ms_per_call`` reads None, and the
    steps' digits are made outside K1 as the key's path says."""
    from zig_tfhe_tpu_torch.ops import blind_rotate_ntt as TBN

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t, prog, found, judged, read = _recorded_calls(split_root,
                                                       "tiny_split.lut_m16")
    finally:
        torch.set_num_threads(n)
    assert judged["wrong"] == 0 and judged["lanes"] == 2 * LUT_M16["lanes"]
    roots = [s for s in found if s.parent is None]
    assert [s.name for s in roots] == [t.call_span] * 2
    by_id = {s.id: s for s in found}
    for root in roots:
        mine = [s for s in found if s.call == root.id]
        tv = [s for s in mine if s.name == "blind_rotate.testvec"]
        steps = [s for s in mine if s.name == "blind_rotate.steps"]
        assert len(tv) == 1 and len(steps) == 1
        assert by_id[tv[0].parent].name == "lut.apply"
        assert tv[0].end_ns <= steps[0].start_ns
    ck = prog.ck
    form = TBN.key_form(prog.params, ck.bsk_ntt, ck.bsk_ntt_drop, ck.bsk_group,
                        ck.bsk_levels, ck.bsk_bgbit)
    G = ck.bsk_ntt.shape[0]
    plain = 1 if form.path is TBN.Path.FUSED else G
    assert steps[0].attrs == {"steps": G, "fused_steps": G - plain,
                              "plain_digit_steps": plain}
    # the wrappers count launches on a card alone
    assert read == {"testvec_ms_per_call": None,
                    "plain_digit_steps_per_call": plain,
                    "k2s_steps_per_call": 0}


@pytest.mark.cuda
def test_a_short_traced_run_of_the_cell_on_the_card(cuda_device):
    bench = manifest.Bench(ROOT)
    r = run.run_cell(bench, CELL, SEED, 2.0, True, cuda_device)
    line = run.result_line(bench, CELL, r, True, cuda_device)
    print(json.dumps({k: line[k] for k in ("correct", "metrics", "device",
                                           "check")}))
    assert line["correct"]
    assert set(line["metrics"]) == set(PER_LAYER)
    assert line["metrics"]["k2s_steps_per_call"]["value"] == 371
    assert line["metrics"]["testvec_ms_per_call"]["value"] > 0
