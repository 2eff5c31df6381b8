"""Device keys of the port, and the carry-across from the JAX package.

`device_key` is the counterpart of `JaxBackend._get_device_key`
(`tfhe_tpu/ops/backend.py:675-740`) for the port's paths: the single-limb
key of the gate and mixed slices (host NTT mod Q, `pack_bsk`), the RNS key
of the accelerated sets (`pack_bsk_rns`, one NTT per prime straight from
`bsk_coeff`, on the key's device), the 64-bit key of the two-limb sets
(`pack_bsk64`, the NTT mod Q and the companions on the key's device) and
the DM table of the AP sets (`pack_dm_table`). The
switching-key table is memoised on the switching-key object, as
`JaxBackend._packed_ksk` does (551-573): every gadget base of a
time-optimization map and every context that shares the LWE block share
one device table.

`params_from`, `key_from` and `ciphertext_from` carry the JAX package's
parameters, keys and ciphertexts (read as plain attributes and numpy
arrays, without importing that package) into the port's own types, so the
two packages can be compared on identical inputs; the `ckks_*_from`,
`bfv_*_from`, `bgv_*_from` and `hybrid_key_from` functions do the same for
its CKKS, BFV and BGV objects. A seeded switching key crosses as its seed
and B.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lwe
from .params import BinFHEParams, LWEParams, Method, RGSWParams
from .ref import ntt as ref_ntt
from .scheme import BTKey
from .ops.blindrotate_dm import pack_dm_table
from .ops.keyswitch import ksk_table, seeded_ksk_table
from .ops.rotate64_kernel import pack_bsk64
from .ops.rotate_kernel import pack_bsk
from .ops.rotate_rns_kernel import pack_bsk_rns
from .pke.bfv import (BFVCiphertext, BFVParams, BFVPublicKey,
                      BFVRelinKey, BFVSecretKey)
from .pke.bgv import BGVParams
from .pke.ckks import CKKSCiphertext, CKKSParams
from .pke.ckks_rns import RnsHybridKey
from .pke.dcrt import DCRTParams, DCRTPoly


def switching_table(ksk, device: torch.device) -> torch.Tensor:
    """The device table of `ksk` (`ksk_table`), built once per key object
    and device; a seeded key's A columns are regenerated on the device
    (`seeded_ksk_table`)."""
    cache = ksk.__dict__.setdefault("_device_tables", {})
    if str(device) not in cache:
        cache[str(device)] = (
            seeded_ksk_table(ksk, device) if isinstance(ksk, lwe.SeededSwitchingKey)
            else ksk_table(ksk.A, ksk.B, device))
    return cache[str(device)]


def device_key(params: BinFHEParams, key: BTKey, device: torch.device,
               path: str) -> dict[str, torch.Tensor]:
    """BTKey -> {"bsk_pack" or "bsk_rns": int32 [n, 8*d2, N], "bsk64":
    int64 [n, 4*d2, N], or "dm_table": int32 [n*digitsR, baseR, d2, 2, N];
    "ksk": [N*baseKS*dc, n + 1]} on `device`. The CGGI key `bsk_coeff`
    [n, 2, d2, 2, N] goes to the layout of the kernel that `path` names:
    "rns", one NTT per prime of Q = q1*q2, and "two_limb", the NTT mod Q,
    on `device`; "gate" or "mixed", the host NTT mod Q. "dm": the DM key
    [n, baseR, digitsR, d2, 2, N]."""
    p = params.lwe
    if path == "dm":
        bsk = {"dm_table": pack_dm_table(key.bsk_coeff, p.Q, device)}
    elif path == "rns":
        q1, q2 = params.rgsw.rns_primes
        bsk = {"bsk_rns": pack_bsk_rns(key.bsk_coeff, q1, q2, device)}
    elif path == "two_limb":
        bsk = {"bsk64": pack_bsk64(key.bsk_coeff, p.Q, device)}
    else:
        bsk_hat = ref_ntt.forward(np.asarray(key.bsk_coeff, dtype=np.uint64), p.Q)
        bsk = {"bsk_pack": pack_bsk(bsk_hat, p.Q).to(device)}
    return {**bsk, "ksk": switching_table(key.ksk, device)}


# -- carry-across from the JAX package ------------------------------------

def params_from(other) -> BinFHEParams:
    """Any parameter bundle with the JAX package's fields -> the port's
    BinFHEParams (same moduli, bases and current gadget base)."""
    o, g = other.lwe, other.rgsw
    lwe_p = LWEParams(n=o.n, N=o.N, q=o.q, Q=o.Q, q_ks=o.q_ks, std=o.std,
                      base_ks=o.base_ks)
    rgsw_p = RGSWParams(N=g.N, Q=g.Q, q=g.q, base_g=g.base_g, base_r=g.base_r,
                        method=Method(int(g.method)), std=g.std,
                        sign_eval=g.sign_eval,
                        num_digits_to_throw=g.num_digits_to_throw)
    return BinFHEParams(lwe=lwe_p, rgsw=rgsw_p,
                        time_optimization=other.time_optimization)


def switching_key_from(other):
    """A JAX-package switching key -> the port's. A seeded key crosses as
    its seed, dimensions and B (its `.A` is never read); a plain key's
    arrays are copied. A seeded key loaded from a file
    (`utils/serial.load_context`) is handled like a generated one: its
    table is regenerated from the seed on the device (`switching_table`)."""
    if hasattr(other, "seed"):
        return lwe.SeededSwitchingKey(
            int(other.seed), int(other.N), int(other.base_ks),
            int(other.digit_count), int(other.n), int(other.q_ks),
            np.asarray(other.B, dtype=np.uint64).copy())
    return lwe.LWESwitchingKey(A=np.asarray(other.A).copy(),
                               B=np.asarray(other.B).copy())


def key_from(other) -> BTKey:
    """A JAX-package BTKey -> the port's BTKey (arrays copied)."""
    ksk = switching_key_from(other.ksk)
    sk_n = (None if other.sk_n is None else
            lwe.LWEPrivateKey(np.asarray(other.sk_n.s).copy(), int(other.sk_n.modulus)))
    return BTKey(bsk_coeff=np.asarray(other.bsk_coeff).copy(), ksk=ksk,
                 base_g=int(other.base_g), sk_n=sk_n)


def ciphertext_from(other) -> lwe.LWECiphertext:
    return lwe.LWECiphertext(np.asarray(other.a).copy(),
                             np.copy(other.b), int(other.modulus))


def _dcrt_params_from(other) -> DCRTParams:
    return DCRTParams(N=int(other.N), moduli=tuple(int(m) for m in other.moduli))


def _dcrt_poly_from(other) -> DCRTPoly:
    return DCRTPoly(_dcrt_params_from(other.params),
                    np.asarray(other.rns, dtype=np.uint64).copy(),
                    bool(other.eval_form))


def ckks_params_from(other) -> CKKSParams:
    """A JAX-package CKKSParams -> the port's (same chain, scale, noise)."""
    return CKKSParams(N=int(other.N), dcrt=_dcrt_params_from(other.dcrt),
                      scale=float(other.scale), std=float(other.std),
                      relin_window=int(other.relin_window))


def ckks_secret_from(other) -> tuple:
    """A JAX-package CKKS secret key (s tower, signed coefficients) -> the
    port's."""
    s, s_signed = other
    return _dcrt_poly_from(s), np.asarray(s_signed, dtype=np.int64).copy()


def ckks_public_from(other) -> tuple:
    """A JAX-package CKKS public key (b, a) -> the port's."""
    return tuple(_dcrt_poly_from(p) for p in other)


def hybrid_key_from(other) -> RnsHybridKey:
    """A JAX-package RnsHybridKey -> the port's, its Galois element kept."""
    key = RnsHybridKey(bs=[_dcrt_poly_from(p) for p in other.bs],
                       as_=[_dcrt_poly_from(p) for p in other.as_],
                       pq_params=_dcrt_params_from(other.pq_params),
                       q_moduli=tuple(int(m) for m in other.q_moduli),
                       p_moduli=tuple(int(m) for m in other.p_moduli),
                       groups=[tuple(int(x) for x in g) for g in other.groups],
                       t=int(other.t))
    if hasattr(other, "galois_k"):
        key.galois_k = int(other.galois_k)
    return key


def ckks_ciphertext_from(other, params: CKKSParams | None = None) -> CKKSCiphertext:
    """A JAX-package CKKSCiphertext -> the port's (towers copied); `params`
    defaults to the carried-across parameters of the ciphertext."""
    return CKKSCiphertext([_dcrt_poly_from(p) for p in other.polys],
                          float(other.scale),
                          ckks_params_from(other.params) if params is None else params,
                          int(other.noise_deg))


def bgv_params_from(other) -> BGVParams:
    """A JAX-package BGVParams (or BFVParams) -> the port's BGVParams (same
    chain, t, noise and relinearization window)."""
    return BGVParams(N=int(other.N), t=int(other.t),
                     dcrt=_dcrt_params_from(other.dcrt), std=float(other.std),
                     relin_window=int(other.relin_window))


def bgv_secret_from(other) -> BFVSecretKey:
    """A JAX-package BFV/BGV secret key -> the port's."""
    return BFVSecretKey(_dcrt_poly_from(other.s),
                        np.asarray(other.s_signed, dtype=np.int64).copy())


def bgv_public_from(other) -> BFVPublicKey:
    """A JAX-package BFV/BGV public key -> the port's."""
    return BFVPublicKey(_dcrt_poly_from(other.b), _dcrt_poly_from(other.a))


def bgv_relin_from(other) -> BFVRelinKey:
    """A JAX-package BFVRelinKey (the host BFV/BGV gadget key, also the
    Galois key of `galois_key_gen` without its element) -> the port's."""
    return BFVRelinKey(b=[_dcrt_poly_from(p) for p in other.b],
                       a=[_dcrt_poly_from(p) for p in other.a])


def bgv_ciphertext_from(other, params: BGVParams | None = None) -> BFVCiphertext:
    """A JAX-package BFV/BGV ciphertext -> the port's (towers copied, noise
    degree kept); `params` defaults to the carried-across parameters."""
    return BFVCiphertext([_dcrt_poly_from(p) for p in other.polys],
                         bgv_params_from(other.params) if params is None else params,
                         int(other.noise_deg))


def bfv_params_from(other) -> BFVParams:
    """A JAX-package BFVParams -> the port's (same chain, t, noise and
    relinearization window)."""
    return BFVParams(N=int(other.N), t=int(other.t),
                     dcrt=_dcrt_params_from(other.dcrt), std=float(other.std),
                     relin_window=int(other.relin_window))


# BFV and BGV share the key types (pke/bfv.py)
bfv_secret_from = bgv_secret_from
bfv_public_from = bgv_public_from


def bfv_ciphertext_from(other, params: BFVParams | None = None) -> BFVCiphertext:
    """A JAX-package BFV ciphertext -> the port's (towers copied, noise
    degree kept); `params` defaults to the carried-across parameters."""
    return BFVCiphertext([_dcrt_poly_from(p) for p in other.polys],
                         bfv_params_from(other.params) if params is None else params,
                         int(other.noise_deg))
