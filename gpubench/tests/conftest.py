"""Tests of the benchmark itself.  They run on the CPU; a test that needs
the card takes the ``cuda_device`` fixture, which skips without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# TEST_TINY (N = 64, n0 = 8, noise-free encryptions): a configuration the
# CPU runs in a second.  Its noise limit sits between the readings of its
# key (~0.001) and of its control key with one b-level fewer (~0.011).
TINY = {
    "params": "tiny", "deployment": "test", "torus_bits": 32, "n0": 8,
    "N": 64, "lwe_alpha": 0.0, "glwe_alpha": 0.0, "bg_bits": 6, "levels": 2,
    "ks_base_bits": 2, "ks_levels": 8, "split_ring": False,
    "key": {"group": 2, "engine_bgbit": 6, "decomp_levels": [2, 2]},
    "drop": 0, "n_primes": 4,
    "control_key": {"group": 2, "engine_bgbit": 6, "decomp_levels": [2, 1]},
    "limits": {"noise_sd": 0.003}}
TINY64 = dict(TINY, params="tiny64", torus_bits=64, n_primes=6)
# one gate a call, back to back
ONE_LANE = {"kind": "gates", "lanes": 1, "gates": "all", "pool": 64,
            "warm_calls": 2, "trace_calls": 8}
# TEST_TINY_UINT (N = 256, n0 = 8, noise-free encryptions, Bg 2^11: 2-limb
# digits): the multi-limb path of the uint sets, in a second.  Its noise
# limit sits between the readings of its key (0.00073-0.00089 on 13
# seeds) and of its control key, Bg_e 2^6 with one b-level fewer
# (0.0065-0.0117, and 0 to 58 wrong lanes a run).
TINY_UINT = {
    "params": "tiny_uint", "deployment": "test", "torus_bits": 32, "n0": 8,
    "N": 256, "lwe_alpha": 0.0, "glwe_alpha": 0.0, "bg_bits": 11, "levels": 2,
    "ks_base_bits": 4, "ks_levels": 3, "split_ring": False,
    "key": {"group": 2, "engine_bgbit": 11, "decomp_levels": [2, 2]},
    "drop": 0, "n_primes": 4,
    "control_key": {"group": 2, "engine_bgbit": 6, "decomp_levels": [2, 1]},
    "limits": {"noise_sd": 0.003}}
# a programmable bootstrap a lane on Z_16, every function of the reference
LUT_M16 = {"kind": "lut", "lanes": 64, "message_modulus": 16,
           "functions": "all", "pool": 4, "warm_calls": 1, "trace_calls": 2}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout whose benchmark has gained, as data only, the
    configurations ``tiny``, ``tiny64`` and ``tiny_uint``, the one-lane
    gate mix ``one_lane``, the LUT mix ``lut_m16``, a cell of ``tiny`` and
    of ``tiny64`` under every gate mix and the cell ``tiny_uint.lut_m16``."""
    traffic = tmp_path / "gpubench" / "traffic"
    shutil.copytree(ROOT / "gpubench" / "traffic", traffic)
    (traffic / "one_lane.json").write_text(json.dumps(ONE_LANE))
    (traffic / "lut_m16.json").write_text(json.dumps(LUT_M16))
    (tmp_path / "gpubench" / "configs").mkdir()
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    gate_mixes = sorted({w["traffic"] for w in m["workloads"]} | {"one_lane"})
    for name, cfg, mixes in (("tiny", TINY, gate_mixes),
                             ("tiny64", TINY64, gate_mixes),
                             ("tiny_uint", TINY_UINT, ["lut_m16"])):
        f = f"gpubench/configs/{name}.json"
        (tmp_path / f).write_text(json.dumps(cfg))
        m["configs"].append({"name": name, "source": "test", "file": f,
                             "reduced": [], "why": "test"})
        for mix in mixes:
            m["workloads"].append({"name": f"{name}.{mix}", "config": name,
                                   "traffic": mix, "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path
