"""Serialization for pke objects (keys, ciphertexts, contexts) — the pke side
of the reference's cereal checkpointing (`src/pke/lib/*-ser.cpp` family).
Same `.npz` convention as the binfhe serializer (utils/serial.py).

Port of `tfhe_tpu/pke/serial.py`. The file format is the JAX package's,
key for key: a file saved by either package loads in the other."""

from __future__ import annotations

import io
import json

import numpy as np

from .bfv import (BFVCiphertext, BFVContext, BFVParams, BFVPublicKey,
                  BFVRelinKey, BFVSecretKey)
from .bgv import BGVContext, BGVParams
from .dcrt import DCRTParams, DCRTPoly


def _params_dict(p: BFVParams) -> dict:
    return {"N": p.N, "t": p.t, "moduli": [str(m) for m in p.dcrt.moduli],
            "std": p.std, "relin_window": p.relin_window,
            "kind": type(p).__name__}


def _params_from(d: dict) -> BFVParams:
    dcrt = DCRTParams(N=d["N"], moduli=tuple(int(m) for m in d["moduli"]))
    cls = BGVParams if d["kind"] == "BGVParams" else BFVParams
    return cls(N=d["N"], t=d["t"], dcrt=dcrt, std=d["std"],
               relin_window=d["relin_window"])


def save_keys(path, params: BFVParams, sk: BFVSecretKey | None = None,
              pk: BFVPublicKey | None = None,
              rlk: BFVRelinKey | None = None) -> None:
    arrays: dict[str, np.ndarray] = {}
    meta = {"params": _params_dict(params),
            "has": {"sk": sk is not None, "pk": pk is not None,
                    "rlk": 0 if rlk is None else len(rlk.b)}}
    if sk is not None:
        arrays["sk_signed"] = np.asarray(sk.s_signed, dtype=np.int64)
    if pk is not None:
        arrays["pk_b"] = pk.b.rns
        arrays["pk_a"] = pk.a.rns
    if rlk is not None:
        for d in range(len(rlk.b)):
            arrays[f"rlk_b{d}"] = rlk.b[d].rns
            arrays[f"rlk_a{d}"] = rlk.a[d].rns
    np.savez_compressed(path, meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_keys(path):
    """Returns (params, sk | None, pk | None, rlk | None)."""
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    params = _params_from(meta["params"])
    dcrt = params.dcrt

    def poly(name):
        return DCRTPoly(dcrt, data[name].astype(np.uint64), eval_form=True)

    sk = None
    if meta["has"]["sk"]:
        s_signed = data["sk_signed"].astype(np.int64)
        sk = BFVSecretKey(DCRTPoly.from_signed(dcrt, s_signed, eval_form=True),
                          s_signed)
    pk = BFVPublicKey(poly("pk_b"), poly("pk_a")) if meta["has"]["pk"] else None
    rlk = None
    n_rlk = meta["has"]["rlk"]
    if n_rlk:
        rlk = BFVRelinKey(b=[poly(f"rlk_b{d}") for d in range(n_rlk)],
                          a=[poly(f"rlk_a{d}") for d in range(n_rlk)])
    return params, sk, pk, rlk


def save_ciphertext(path, ct: BFVCiphertext) -> None:
    meta = {"params": _params_dict(ct.params), "k": len(ct.polys)}
    arrays = {f"c{i}": ct.polys[i].rns for i in range(len(ct.polys))}
    np.savez_compressed(path, meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_ciphertext(path) -> BFVCiphertext:
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    params = _params_from(meta["params"])
    polys = [DCRTPoly(params.dcrt, data[f"c{i}"].astype(np.uint64), eval_form=True)
             for i in range(meta["k"])]
    return BFVCiphertext(polys, params)


def save_ckks_ciphertext(path, ct) -> None:
    """Serialize a CKKSCiphertext: towers (possibly at a reduced chain) +
    scale + noise degree — the cereal Ciphertext<DCRTPoly> analogue for
    CKKS, where the scale/degree metadata is part of the ciphertext state
    (ckksrns scalingFactor / noiseScaleDeg)."""
    lp = ct.polys[0].params
    meta = {"N": lp.N, "moduli": [str(m) for m in lp.moduli],
            "scale": repr(ct.scale), "noise_deg": ct.noise_deg,
            "k": len(ct.polys),
            "full_moduli": [str(m) for m in ct.params.dcrt.moduli],
            "params_scale": repr(ct.params.scale)}
    arrays = {f"c{i}": ct.polys[i].rns for i in range(len(ct.polys))}
    np.savez_compressed(path, meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_ckks_ciphertext(path):
    from .ckks import CKKSCiphertext, CKKSParams
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    lp = DCRTParams(N=meta["N"],
                    moduli=tuple(int(m) for m in meta["moduli"]))
    full = DCRTParams(N=meta["N"],
                      moduli=tuple(int(m) for m in meta["full_moduli"]))
    params = CKKSParams(N=meta["N"], dcrt=full,
                        scale=float(meta["params_scale"]))
    polys = [DCRTPoly(lp, data[f"c{i}"].astype(np.uint64), eval_form=True)
             for i in range(meta["k"])]
    return CKKSCiphertext(polys, float(meta["scale"]), params,
                          noise_deg=int(meta["noise_deg"]))


def dumps_keys(*args, **kwargs) -> bytes:
    buf = io.BytesIO()
    save_keys(buf, *args, **kwargs)
    return buf.getvalue()


# -- pure-RNS hybrid (GHS) keys ---------------------------------------------

def save_hybrid_keys(path, keys) -> None:
    """Serialize RNS hybrid key material (ckks_rns.RnsHybridKey): a single
    key, or the per-level dicts produced by relin_key_gen/galois_key_gen
    (the pke side of the reference's EvalKey serialization)."""
    from .ckks_rns import RnsHybridKey
    if isinstance(keys, RnsHybridKey):
        keys = {0: keys}
    meta: dict = {"levels": {}}
    arrays: dict[str, np.ndarray] = {}
    for lvl, k in keys.items():
        meta["levels"][str(lvl)] = {
            "N": k.pq_params.N,
            "q_moduli": [str(m) for m in k.q_moduli],
            "p_moduli": [str(m) for m in k.p_moduli],
            "groups": [list(g) for g in k.groups],
            "t": k.t,
            "galois_k": getattr(k, "galois_k", None),
            "n_groups": len(k.bs),
        }
        for g in range(len(k.bs)):
            arrays[f"k{lvl}_b{g}"] = k.bs[g].rns
            arrays[f"k{lvl}_a{g}"] = k.as_[g].rns
    np.savez_compressed(path, meta=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_hybrid_keys(path):
    """Returns the per-level dict (or the single key if saved bare)."""
    from .ckks_rns import RnsHybridKey
    data = np.load(path)
    meta = json.loads(bytes(data["meta"]).decode())
    out = {}
    for lvl_s, m in meta["levels"].items():
        q_moduli = tuple(int(x) for x in m["q_moduli"])
        p_moduli = tuple(int(x) for x in m["p_moduli"])
        pq = DCRTParams(N=m["N"], moduli=q_moduli + p_moduli)
        bs, as_ = [], []
        for g in range(m["n_groups"]):
            bs.append(DCRTPoly(pq, data[f"k{lvl_s}_b{g}"].astype(np.uint64),
                               eval_form=True))
            as_.append(DCRTPoly(pq, data[f"k{lvl_s}_a{g}"].astype(np.uint64),
                                eval_form=True))
        key = RnsHybridKey(bs, as_, pq, q_moduli, p_moduli,
                           [tuple(g) for g in m["groups"]], m["t"])
        if m["galois_k"] is not None:
            key.galois_k = m["galois_k"]
        out[int(lvl_s)] = key
    return out[0] if set(out) == {0} else out
