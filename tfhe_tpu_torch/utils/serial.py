"""Serialization: save/load contexts, keys, and ciphertexts.

Replaces the reference's cereal-based checkpointing (`utils/serial.h:100-176`,
`binfhecontext-ser.h`, demonstrated in examples/boolean-serial-*.cpp): every
crypto object round-trips through a single `.npz` file (binary) — parameters
as JSON metadata, key material as dense arrays. Like the reference, device
state is not checkpointed; `device_setup` re-uploads from host keys
(GPU state is likewise rebuilt by GPUSetup in the reference).

Port of `tfhe_tpu/utils/serial.py` on the port's `lwe`, `params` and
`scheme.BTKey`. The file format is the JAX package's, key for key: a file
saved by either package loads in the other. A seeded switching key is
saved as its seed, dimensions and B, and loads as a seeded key again; its
A block is never materialized for the binary form (the JSON form writes A,
as the JAX package's does).
"""

from __future__ import annotations

import io
import json

import numpy as np

from .. import lwe
from ..params import BinFHEParams, LWEParams, Method, RGSWParams
from ..scheme import BTKey


def _params_to_dict(p: BinFHEParams) -> dict:
    return {
        "lwe": {"n": p.lwe.n, "N": p.lwe.N, "q": p.lwe.q, "Q": p.lwe.Q,
                "q_ks": p.lwe.q_ks, "std": p.lwe.std, "base_ks": p.lwe.base_ks},
        "rgsw": {"N": p.rgsw.N, "Q": p.rgsw.Q, "q": p.rgsw.q,
                 "base_g": p.rgsw.base_g, "base_r": p.rgsw.base_r,
                 "method": int(p.rgsw.method), "std": p.rgsw.std,
                 "sign_eval": p.rgsw.sign_eval,
                 "num_digits_to_throw": p.rgsw.num_digits_to_throw},
        "time_optimization": p.time_optimization,
    }


def _params_from_dict(d: dict) -> BinFHEParams:
    lp = LWEParams(**d["lwe"])
    rd = dict(d["rgsw"])
    rd["method"] = Method(rd["method"])
    rp = RGSWParams(**rd)
    return BinFHEParams(lwe=lp, rgsw=rp, time_optimization=d["time_optimization"])


def save_context(path: str, params: BinFHEParams,
                 bt_key: BTKey | None = None,
                 bt_key_map: dict[int, BTKey] | None = None) -> None:
    """Serialize parameters and (optionally) the bootstrapping key material."""
    arrays: dict[str, np.ndarray] = {}
    meta = {"params": _params_to_dict(params), "keys": []}
    key_items = []
    if bt_key_map:
        key_items = sorted(bt_key_map.items())
    elif bt_key is not None:
        key_items = [(bt_key.base_g, bt_key)]
    for base_g, key in key_items:
        tag = f"k{base_g}"
        entry = {"base_g": base_g, "tag": tag}
        arrays[f"{tag}_bsk"] = np.asarray(key.bsk_coeff, dtype=np.uint64)
        if isinstance(key.ksk, lwe.SeededSwitchingKey):
            # seeded keys serialize as (seed, B) — the multi-GB A block is
            # a deterministic threefry stream, regenerated on load
            k = key.ksk
            entry["ksk_seeded"] = {"seed": k.seed, "N": k.N,
                                   "base_ks": k.base_ks,
                                   "digit_count": k.digit_count,
                                   "n": k.n, "q_ks": k.q_ks}
        else:
            arrays[f"{tag}_ksk_a"] = np.asarray(key.ksk.A, dtype=np.uint64)
        arrays[f"{tag}_ksk_b"] = np.asarray(key.ksk.B, dtype=np.uint64)
        meta["keys"].append(entry)
    np.savez_compressed(path, meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_context(path: str) -> tuple[BinFHEParams, dict[int, BTKey]]:
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    params = _params_from_dict(meta["params"])
    keys: dict[int, BTKey] = {}
    for entry in meta["keys"]:
        tag = entry["tag"]
        if "ksk_seeded" in entry:
            s = entry["ksk_seeded"]
            ksk = lwe.SeededSwitchingKey(
                s["seed"], s["N"], s["base_ks"], s["digit_count"],
                s["n"], s["q_ks"], data[f"{tag}_ksk_b"])
        else:
            ksk = lwe.LWESwitchingKey(A=data[f"{tag}_ksk_a"],
                                      B=data[f"{tag}_ksk_b"])
        keys[entry["base_g"]] = BTKey(
            bsk_coeff=data[f"{tag}_bsk"], ksk=ksk, base_g=entry["base_g"])
    return params, keys


def save_ciphertext(path: str, ct: lwe.LWECiphertext) -> None:
    np.savez_compressed(path, a=np.asarray(ct.a, dtype=np.uint64),
                        b=np.asarray(ct.b, dtype=np.uint64),
                        modulus=np.uint64(ct.modulus))


def load_ciphertext(path: str) -> lwe.LWECiphertext:
    d = np.load(path)
    b = d["b"]
    return lwe.LWECiphertext(d["a"], b if b.ndim else np.uint64(b), int(d["modulus"]))


def save_private_key(path: str, sk: lwe.LWEPrivateKey) -> None:
    np.savez_compressed(path, s=sk.s, modulus=np.uint64(sk.modulus))


def load_private_key(path: str) -> lwe.LWEPrivateKey:
    d = np.load(path)
    return lwe.LWEPrivateKey(d["s"].astype(np.int64), int(d["modulus"]))


def dumps_context(params: BinFHEParams, bt_key: BTKey | None = None,
                  bt_key_map: dict[int, BTKey] | None = None) -> bytes:
    buf = io.BytesIO()
    save_context(buf, params, bt_key, bt_key_map)
    return buf.getvalue()


def loads_context(blob: bytes) -> tuple[BinFHEParams, dict[int, BTKey]]:
    return load_context(io.BytesIO(blob))


# ---------------------------------------------------------------------------
# JSON serialization (cereal SerType::JSON analogue; examples
# boolean-serial-json*.cpp). Arrays are base64-encoded little-endian uint64.
# ---------------------------------------------------------------------------

def _arr_to_json(a: np.ndarray) -> dict:
    import base64
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint64))
    return {"shape": list(a.shape),
            "data": base64.b64encode(a.astype("<u8").tobytes()).decode()}


def _arr_from_json(d: dict) -> np.ndarray:
    import base64
    raw = np.frombuffer(base64.b64decode(d["data"]), dtype="<u8")
    return raw.reshape(d["shape"]).astype(np.uint64)


def save_context_json(path, params: BinFHEParams,
                      bt_key: BTKey | None = None,
                      bt_key_map: dict[int, BTKey] | None = None) -> None:
    doc = {"params": _params_to_dict(params), "keys": []}
    key_items = (sorted(bt_key_map.items()) if bt_key_map
                 else ([(bt_key.base_g, bt_key)] if bt_key is not None else []))
    for base_g, key in key_items:
        doc["keys"].append({
            "base_g": base_g,
            "bsk": _arr_to_json(key.bsk_coeff),
            "ksk_a": _arr_to_json(key.ksk.A),
            "ksk_b": _arr_to_json(key.ksk.B),
        })
    if hasattr(path, "write"):
        json.dump(doc, path)
    else:
        with open(path, "w") as f:
            json.dump(doc, f)


def load_context_json(path) -> tuple[BinFHEParams, dict[int, BTKey]]:
    if hasattr(path, "read"):
        doc = json.load(path)
    else:
        with open(path) as f:
            doc = json.load(f)
    params = _params_from_dict(doc["params"])
    keys: dict[int, BTKey] = {}
    for entry in doc["keys"]:
        keys[entry["base_g"]] = BTKey(
            bsk_coeff=_arr_from_json(entry["bsk"]),
            ksk=lwe.LWESwitchingKey(A=_arr_from_json(entry["ksk_a"]),
                                    B=_arr_from_json(entry["ksk_b"])),
            base_g=entry["base_g"])
    return params, keys
