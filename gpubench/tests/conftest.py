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


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout whose benchmark has gained, as data only, the
    configurations ``tiny`` and ``tiny64``, the one-lane mix ``one_lane``
    and a cell of each configuration under every mix."""
    shutil.copytree(ROOT / "gpubench" / "traffic", tmp_path / "gpubench" / "traffic")
    (tmp_path / "gpubench" / "traffic" / "one_lane.json").write_text(json.dumps(ONE_LANE))
    (tmp_path / "gpubench" / "configs").mkdir()
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    mixes = sorted({w["traffic"] for w in m["workloads"]} | {"one_lane"})
    for name, cfg in (("tiny", TINY), ("tiny64", TINY64)):
        f = f"gpubench/configs/{name}.json"
        (tmp_path / f).write_text(json.dumps(cfg))
        m["configs"].append({"name": name, "source": "test", "file": f,
                             "reduced": [], "why": "test"})
        for mix in mixes:
            m["workloads"].append({"name": f"{name}.{mix}", "config": name,
                                   "traffic": mix, "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path
