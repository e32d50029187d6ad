"""The system under test: ``zig_tfhe_tpu_torch``, reached only through its
public entry points (``params``, ``key``, and what each traffic kind's file
under ``kinds/`` calls) and its hand kernels' launch counters.

The secret key is drawn here from the seed (NumPy); the cloud key is made
on the device by the program's own ``CloudKey.generate`` from a
``torch.Generator`` seeded alike.  A configuration's ``key`` entry is
passed to it as given, and the key that comes back is held to the
configuration's stated form.  Each kind's program adapter is a ``Keys``
with its own ``encrypt`` and ``apply``.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from zig_tfhe_tpu_torch import key as _key
from zig_tfhe_tpu_torch import params as _params

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


def secret_keys(seed: int, n0: int, n1: int):
    """The binary lv0 and lv1 keys (int32 [n0], [n1]) that ``seed`` draws."""
    r = traffic.rng(seed, traffic.STREAM_SECRET_KEY)
    return (r.integers(0, 2, n0).astype(np.int32),
            r.integers(0, 2, n1).astype(np.int32))


class Keys:
    """One configuration's keys on ``device``: ``sk``, ``ck``, ``gen``
    (the device generator the client's encryptions draw from) and
    ``key_lv0``, the secret key the reference decrypts with.

    ``key_form`` (the configuration's ``control_key``) replaces the stated
    key form; its key is held to the form it asks for, and takes the drop
    and the primes that the program picks for it."""

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
        self.key_lv0, key_lv1 = secret_keys(seed, p.n0, p.n1)
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
        if key_form is not None:
            got, want = got[:3], want[:3]
        if got != want:
            raise RuntimeError(f"the key came out (group, Bg_e bits, levels, "
                               f"drop, primes) = {got}, not {want} as the "
                               f"configuration states")

    def free(self) -> None:
        """Drop the program's keys (before the reference runs)."""
        self.ck = self.sk = None
