"""Loading keys written by zig_tfhe_tpu/utils/serialization.py, without JAX.

The format is a numpy ``.npz`` with a JSON ``__manifest__`` entry that
carries the object kind and every field of the parameter set.  Only the
load side of the secret and cloud keys is ported; the save side is a later
slice.
"""

from __future__ import annotations

import json
import os

import numpy as np

from zig_tfhe_tpu_torch import key as K
from zig_tfhe_tpu_torch import params as P

_KIND_SECRET = "secret_key"
_KIND_CLOUD = "cloud_key"


def _npz_path(path) -> str:
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _params_from_doc(m: dict) -> P.SecurityParams:
    """The exact SecurityParams from the manifest (the stock instance when
    it matches field for field; the set name for pre-v1 files)."""
    doc = m.get("params_full")
    if doc is None:
        name = m.get("params", "")
        if name not in P.PARAMS_BY_NAME:
            raise ValueError(f"file lacks embedded parameters and names an "
                             f"unknown set {name!r}")
        return P.PARAMS_BY_NAME[name]
    params = P.SecurityParams(
        security_bits=doc["security_bits"],
        description=doc["description"],
        tlwe_lv0=P.TlweParams(**doc["tlwe_lv0"]),
        tlwe_lv1=P.TlweParams(**doc["tlwe_lv1"]),
        trlwe_lv1=P.TrlweParams(**doc["trlwe_lv1"]),
        trgsw_lv1=P.TrgswParams(**doc["trgsw_lv1"]),
        name=doc.get("name", ""),
        torus_bits=doc.get("torus_bits", 32),
    )
    stock = P.PARAMS_BY_NAME.get(params.name)
    return stock if stock == params else params


def _load(path, kind: str):
    """Arrays and manifest of an .npz of the given kind (raises on others)."""
    with np.load(_npz_path(path)) as z:
        if "__manifest__" not in z:
            raise ValueError(f"{path}: not a zig_tfhe_tpu file (no manifest)")
        m = json.loads(bytes(z["__manifest__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__manifest__"}
    if not str(m.get("format", "")).startswith("zig_tfhe_tpu."):
        raise ValueError(f"{path}: unknown format {m.get('format')!r}")
    if m.get("kind") != kind:
        raise ValueError(
            f"{path}: expected a {kind!r} file, found {m.get('kind')!r}")
    return arrays, m


def load_secret_key(path, device="cuda"):
    """Returns (SecretKey, params)."""
    arrays, m = _load(path, _KIND_SECRET)
    return (K.SecretKey.from_numpy(arrays["key_lv0"], arrays["key_lv1"],
                                   device), _params_from_doc(m))


def load_cloud_key(path, device="cuda") -> K.CloudKey:
    """A cloud key with its bootstrapping key forms (``bsk_ntt``,
    ``bsk_ext_limbs``: either or both) on ``device``; raises for a file
    with neither."""
    arrays, m = _load(path, _KIND_CLOUD)
    return K.CloudKey.from_numpy(
        arrays, _params_from_doc(m), bsk_ntt_drop=m.get("bsk_ntt_drop", 0),
        bsk_group=m.get("bsk_group", 1), bsk_levels=m.get("bsk_levels"),
        bsk_bgbit=m.get("bsk_bgbit"), device=device)
