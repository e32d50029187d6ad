"""The system under test: ``zig_tfhe_tpu_torch``, reached only through its
public entry points (``params``, ``key``, ``tlwe``, ``models.gates``) and
its hand kernels' launch counters.

The secret key is drawn here from the seed (NumPy); the cloud key is made
on the device by the program's own ``CloudKey.generate`` from a
``torch.Generator`` seeded alike.  A configuration's ``key`` entry is
passed to it as given, and the key that comes back is held to the
configuration's stated form.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from zig_tfhe_tpu_torch import key as _key
from zig_tfhe_tpu_torch import params as _params
from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch.models import gates as _gates

from gpubench import traffic

# each hand kernel: its wrapper (module, function) and its symbol in a trace
HAND_KERNELS = {
    "k1": ("ntt_inverse", "ntt_inverse_to_crt_acc", "ntt_inverse_crt_acc_kernel"),
    "k2": ("ntt_step", "ntt_step_fused", "ntt_step_fused_kernel"),
    "k2s": ("split_step", "split_step_fused", "split_step_kernel"),
    "k3": ("extprod", "extprod_matmul", "extprod_matmul_kernel"),
}


def _wrapper(k: str):
    mod, fn, _ = HAND_KERNELS[k]
    return getattr(importlib.import_module(
        f"zig_tfhe_tpu_torch.ops.cuda.{mod}"), fn)


def launches() -> dict:
    """Each hand kernel's launches counted by its wrapper so far."""
    return {k: _wrapper(k).launches for k in HAND_KERNELS}


class Gates:
    """One configuration's keys and its gate batches on ``device``."""

    def __init__(self, cfg: dict, seed: int, device, key_form: dict | None = None):
        self.params = _params.PARAMS_BY_NAME[cfg["params"]]
        p = self.params
        got = (p.torus_bits, p.n0, p.N, p.tlwe_lv0.alpha, p.tlwe_lv1.alpha,
               p.bgbit, p.L, p.basebit, p.iks_t, p.split_ring)
        want = tuple(cfg[k] for k in ("torus_bits", "n0", "N", "lwe_alpha",
                                      "glwe_alpha", "bg_bits", "levels",
                                      "ks_base_bits", "ks_levels", "split_ring"))
        if got != want:
            raise RuntimeError(f"parameter set {cfg['params']} is {got}, not "
                               f"{want} as the configuration states")
        self.width = p.torus_bits
        self.device = torch.device(device)
        r = traffic.rng(seed, traffic.STREAM_SECRET_KEY)
        self.key_lv0 = r.integers(0, 2, self.params.n0).astype(np.int32)
        key_lv1 = r.integers(0, 2, self.params.n1).astype(np.int32)
        self.sk = _key.SecretKey.from_numpy(self.key_lv0, key_lv1, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed & (2 ** 64 - 1))
        form = dict(cfg["key"] if key_form is None else key_form)
        form["decomp_levels"] = tuple(form["decomp_levels"])
        self.ck = _key.CloudKey.generate(self.gen, self.sk, self.params, **form)
        got = (self.ck.bsk_group, self.ck.bsk_bgbit, self.ck.bsk_levels,
               self.ck.bsk_ntt_drop, self.ck.bsk_ntt.shape[-4])
        want = (form["group"], form["engine_bgbit"], form["decomp_levels"],
                cfg["drop"], cfg["n_primes"])
        if got != want:
            raise RuntimeError(f"the key came out (group, Bg_e bits, levels, "
                               f"drop, primes) = {got}, not {want} as the "
                               f"configuration states")

    def encrypt(self, bits: np.ndarray) -> torch.Tensor:
        """Fresh encryptions of booleans [...] -> carriers [..., n0 + 1]."""
        return _tlwe.encrypt_bool(self.gen, torch.from_numpy(bits).to(self.device),
                                  self.params.tlwe_lv0.alpha, self.sk.key_lv0,
                                  width=self.width)

    def apply(self, gate_ids: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
        return _gates.apply_gates(gate_ids, a, b, self.ck)

    def free(self) -> None:
        """Drop the program's keys (before the reference runs)."""
        self.ck = self.sk = None
