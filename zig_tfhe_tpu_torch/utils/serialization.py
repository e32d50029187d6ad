"""Keys and ciphertexts in the file format of
zig_tfhe_tpu/utils/serialization.py, without JAX.

The format is a numpy ``.npz`` with a JSON ``__manifest__`` entry that
carries the object kind and every field of the parameter set; ciphertexts
are stored as uint32 (uint64 on the 64-bit torus), key material as
int8/int16/int32 (int64 torus arrays on the 64-bit sets, a split-ring set's
NTT key in its folded split form).  Files written here load into the JAX
package and the other way round.  Ported: the secret key, the cloud key
(its packing key included), the ciphertext and the stand-alone packing key,
both ways, at both widths; the public and re-encryption keys of
models/proxy_reenc.py and the seeded ciphertext at width 32 (the JAX
package's width-64 seeded files do not round-trip, tlwe.py:
encrypt_torus_seeded).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from zig_tfhe_tpu_torch import key as K
from zig_tfhe_tpu_torch import params as P
from zig_tfhe_tpu_torch import tlwe as _tlwe
from zig_tfhe_tpu_torch.models import proxy_reenc as PR
from zig_tfhe_tpu_torch.utils.torus import carrier_dtype

_KIND_SECRET = "secret_key"
_KIND_CLOUD = "cloud_key"
_KIND_CIPHERTEXT = "ciphertext"
_KIND_PACKING = "packing_ksk"
_KIND_PUBLIC = "public_key"
_KIND_REENC = "reenc_key"
_KIND_SEEDED = "seeded_ciphertext"


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


def _manifest(kind: str, params: P.SecurityParams, extra=None) -> np.ndarray:
    doc = {"format": "zig_tfhe_tpu.v1", "kind": kind, "params": params.name,
           "params_full": dataclasses.asdict(params)}
    if extra:
        doc.update(extra)
    return np.frombuffer(json.dumps(doc).encode(), dtype=np.uint8)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


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


def save_secret_key(path, sk: K.SecretKey, params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(_KIND_SECRET, params),
             key_lv0=_numpy(sk.key_lv0), key_lv1=_numpy(sk.key_lv1))


def save_cloud_key(path, ck: K.CloudKey) -> None:
    """The cloud key's arrays (testvec and ksk1 at the carrier, bsk_ntt
    int16, bsk_ext_limbs int8, the forms it holds, and pksk at the carrier
    where it has one) and its static fields, the packing key's (basebit, t) among them
    (the set's (basebit, iks_t) for a key that does not record it)."""
    arrays = {name: _numpy(buf) for name, buf in ck.named_buffers()}
    extra = {"bsk_ntt_drop": ck.bsk_ntt_drop, "bsk_group": ck.bsk_group,
             "bsk_levels": (list(ck.bsk_levels)
                            if ck.bsk_levels is not None else None),
             "bsk_bgbit": ck.bsk_bgbit}
    if ck.pksk is not None:
        extra["pksk_gadget"] = list(
            ck.pksk_gadget if ck.pksk_gadget is not None
            else (ck.params.basebit, ck.params.iks_t))
    np.savez(path, __manifest__=_manifest(_KIND_CLOUD, ck.params, extra),
             **arrays)


def load_cloud_key(path, device="cuda") -> K.CloudKey:
    """A cloud key with its bootstrapping key forms (``bsk_ntt``,
    ``bsk_ext_limbs``: either or both) and its packing key where the file
    has one, on ``device``; raises for a file with neither BSK form.  A
    file with ``pksk`` but no recorded ``pksk_gadget`` (written before the
    field existed) takes the set's (basebit, iks_t), as CloudKey.generate
    always built it."""
    arrays, m = _load(path, _KIND_CLOUD)
    params = _params_from_doc(m)
    gadget = m.get("pksk_gadget")
    if gadget is None and "pksk" in arrays:
        gadget = (params.basebit, params.iks_t)
    return K.CloudKey.from_numpy(
        arrays, params, bsk_ntt_drop=m.get("bsk_ntt_drop", 0),
        bsk_group=m.get("bsk_group", 1), bsk_levels=m.get("bsk_levels"),
        bsk_bgbit=m.get("bsk_bgbit"), pksk_gadget=gadget, device=device)


def save_ciphertext(path, ct: torch.Tensor, params: P.SecurityParams) -> None:
    """A ciphertext array of any shape at the set's carrier (int32, or
    int64 on the 64-bit torus), stored as uint32 (uint64)."""
    want = carrier_dtype(params.torus_bits)
    if ct.dtype != want:
        raise TypeError(f"ciphertexts of a {params.torus_bits}-bit set are "
                        f"{want}, not {ct.dtype}")
    u = np.uint32 if params.torus_bits == 32 else np.uint64
    np.savez(path, __manifest__=_manifest(_KIND_CIPHERTEXT, params),
             ct=_numpy(ct).view(u))


def load_ciphertext(path, device="cuda"):
    """Returns (ct on ``device`` at the set's carrier, params)."""
    arrays, m = _load(path, _KIND_CIPHERTEXT)
    params = _params_from_doc(m)
    i = np.int32 if params.torus_bits == 32 else np.int64
    ct = torch.from_numpy(arrays["ct"].view(i).copy()).to(device)
    return ct, params


def save_packing_ksk(path, pksk: torch.Tensor, params: P.SecurityParams,
                     basebit: int | None = None, t: int | None = None) -> None:
    """A packing key-switch key (ops/packing_keyswitch.py:gen_packing_ksk)
    with the (basebit, t) it was built at: the set's key-switch settings
    unless given (as the JAX package records them)."""
    np.savez(path, __manifest__=_manifest(
        _KIND_PACKING, params,
        {"basebit": params.basebit if basebit is None else basebit,
         "t": params.iks_t if t is None else t}),
        pksk=_numpy(pksk))


def load_packing_ksk(path, device="cuda"):
    """Returns (pksk on ``device`` at the set's carrier, params, basebit,
    t)."""
    arrays, m = _load(path, _KIND_PACKING)
    params = _params_from_doc(m)
    i = np.int32 if params.torus_bits == 32 else np.int64
    pksk = torch.from_numpy(arrays["pksk"].astype(i)).to(device)
    return pksk, params, m["basebit"], m["t"]


def save_seeded_ciphertext(path, mask_seed, b: torch.Tensor,
                           params: P.SecurityParams) -> None:
    """A seeded (compressed) TLWE batch: the mask seed's threefry key data
    (uint32 [2]) and the bodies (stored as uint32), (n0+1)x smaller than
    the expanded batch (tlwe.encrypt_*_seeded / tlwe.expand_seeded).

    ``mask_seed`` must be the first element of encrypt_*_seeded's return,
    the published seed of the mask; the noise's randomness is never
    stored (see tlwe.encrypt_torus_seeded's SECURITY note).  32-bit sets
    only (ValueError otherwise)."""
    _tlwe.require_seeded_width(params.torus_bits)
    if b.dtype != torch.int32:
        raise TypeError(f"seeded bodies are int32, not {b.dtype}")
    np.savez(path, __manifest__=_manifest(_KIND_SEEDED, params),
             key_data=np.asarray(mask_seed, dtype=np.uint32).reshape(2),
             b=_numpy(b).view(np.uint32))


def load_seeded_ciphertext(path, expand: bool = True, device="cuda"):
    """Returns (ct, params) with ct int32 [..., n0+1] expanded on
    ``device`` (expand=True), or ((mask_seed, b), params) in the compressed
    form (mask_seed numpy uint32 [2], b int32 on ``device``)."""
    arrays, m = _load(path, _KIND_SEEDED)
    params = _params_from_doc(m)
    _tlwe.require_seeded_width(params.torus_bits)
    mask_seed = arrays["key_data"].astype(np.uint32)
    b = torch.from_numpy(arrays["b"].view(np.int32).copy()).to(device)
    if not expand:
        return (mask_seed, b), params
    return _tlwe.expand_seeded(mask_seed, b, params.n0), params


def save_public_key(path, pk: PR.PublicKeyLv0,
                    params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(_KIND_PUBLIC, params),
             encryptions=_numpy(pk.encryptions))


def load_public_key(path, device="cuda"):
    """Returns (PublicKeyLv0 on ``device``, params)."""
    arrays, m = _load(path, _KIND_PUBLIC)
    return (PR.PublicKeyLv0.from_numpy(arrays["encryptions"], device),
            _params_from_doc(m))


def save_reenc_key(path, rk: PR.ProxyReencryptionKey,
                   params: P.SecurityParams) -> None:
    np.savez(path, __manifest__=_manifest(
        _KIND_REENC, params, {"basebit": rk.basebit, "t": rk.t}),
        key_encryptions=_numpy(rk.key_encryptions))


def load_reenc_key(path, device="cuda"):
    """Returns (ProxyReencryptionKey on ``device``, params)."""
    arrays, m = _load(path, _KIND_REENC)
    return (PR.ProxyReencryptionKey.from_numpy(
        arrays["key_encryptions"], m["basebit"], m["t"], device),
        _params_from_doc(m))
