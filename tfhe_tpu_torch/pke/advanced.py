"""Advanced SHE operations, proxy re-encryption, and threshold (multiparty)
primitives for the BFV family — counterparts of the reference's
`schemebase/base-advancedshe.cpp`, `base-pre.cpp`, and `base-multiparty.cpp`.
Port of `tfhe_tpu/pke/advanced.py`, line for line (host, numpy).
"""

from __future__ import annotations

import numpy as np

from .bfv import (BFVCiphertext, BFVContext, BFVPublicKey, BFVRelinKey,
                  BFVSecretKey, _automorph)
from .dcrt import DCRTPoly


# ---------------------------------------------------------------------------
# advancedshe: EvalSum / inner product over packed slots
# ---------------------------------------------------------------------------

def eval_sum_key_gen(cc: BFVContext, sk: BFVSecretKey) -> dict:
    """Galois keys for rotations by powers of two (EvalSumKeyGen,
    base-advancedshe.cpp)."""
    keys = {}
    steps = 1
    while steps < cc.params.N // 2:
        keys[steps] = cc.galois_key_gen(sk, steps)
        steps *= 2
    return keys


def eval_sum(cc: BFVContext, ct: BFVCiphertext, sum_keys: dict) -> BFVCiphertext:
    """Sum all (first-half) packed slots into every slot (EvalSum,
    base-advancedshe.cpp): log2(slots) rotate-and-add rounds."""
    out = ct
    steps = 1
    while steps < cc.params.N // 2:
        out = cc.eval_add(out, cc.eval_rotate(out, sum_keys[steps]))
        steps *= 2
    return out


def eval_inner_product(cc: BFVContext, ct1: BFVCiphertext, ct2: BFVCiphertext,
                       rlk: BFVRelinKey, sum_keys: dict) -> BFVCiphertext:
    """<ct1, ct2> over packed slots: slot-wise multiply then EvalSum
    (EvalInnerProduct, base-advancedshe.cpp)."""
    return eval_sum(cc, cc.eval_mult(ct1, ct2, rlk), sum_keys)


# ---------------------------------------------------------------------------
# PRE: proxy re-encryption (base-pre.cpp)
# ---------------------------------------------------------------------------

def re_key_gen(cc: BFVContext, sk_from: BFVSecretKey,
               sk_to: BFVSecretKey) -> BFVRelinKey:
    """Re-encryption key: gadget encryptions of T^d * s_from under s_to
    (ReKeyGen, base-pre.cpp) — switching a ciphertext's key without
    decrypting."""
    p = cc.params
    T = 1 << p.relin_window
    n_digits = (p.Q.bit_length() + p.relin_window - 1) // p.relin_window
    rk = BFVRelinKey()
    for d in range(n_digits):
        a_d = cc._uniform()
        e_d = cc._gaussian()
        rk.b.append(-(a_d * sk_to.s + e_d)
                    + sk_from.s.mul_scalar(pow(T, d, p.Q)))
        rk.a.append(a_d)
    return rk


def re_encrypt(cc: BFVContext, ct: BFVCiphertext, rk: BFVRelinKey,
               public_key: BFVPublicKey | None = None) -> BFVCiphertext:
    """ReEncrypt (base-pre.cpp:47-66): key-switch the c1 component from the
    delegator's key to the delegatee's. When the delegator's `public_key`
    is supplied, the ciphertext is first re-randomized with a NOISE-FLOODED
    encryption of zero (EncryptZeroCore with the flooding distribution,
    base-pre.cpp:55-62) — the HRA-security mode, hiding the original
    ciphertext's randomness from the delegatee."""
    p = cc.params
    assert len(ct.polys) == 2
    if public_key is not None:
        u, _ = cc._ternary()
        e_flood = DCRTPoly.from_signed(
            p.dcrt, cc.rng.flooding_gaussian_signed(p.N, MP_SD),
            eval_form=True)
        ct = BFVCiphertext(
            [ct.polys[0] + public_key.b * u + e_flood,
             ct.polys[1] + public_key.a * u + cc._gaussian()],
            p, ct.noise_deg)
    T = 1 << p.relin_window
    c1_big = ct.polys[1].to_bigint()
    c0 = ct.polys[0]
    c1 = DCRTPoly.zero(p.dcrt, eval_form=True)
    for d in range(len(rk.b)):
        digit = [(c >> (p.relin_window * d)) & (T - 1) for c in c1_big]
        dp = DCRTPoly.from_bigint(p.dcrt, digit).to_eval()
        c0 = c0 + rk.b[d] * dp
        c1 = c1 + rk.a[d] * dp
    return BFVCiphertext([c0, c1], p)


# ---------------------------------------------------------------------------
# Threshold / multiparty (base-multiparty.cpp)
# ---------------------------------------------------------------------------

def multiparty_key_gen(cc: BFVContext, n_parties: int):
    """n-of-n threshold keys: the joint secret is the sum of party secrets;
    the joint public key is built round-robin against a common `a`
    (MultipartyKeyGen, base-multiparty.cpp)."""
    parties = []
    a = cc._uniform()
    b = None
    s_sum = None
    for _ in range(n_parties):
        s, s_signed = cc._ternary()
        e = cc._gaussian()
        parties.append(BFVSecretKey(s, s_signed))
        contrib = -(a * s + e)
        b = contrib if b is None else b + contrib
        s_sum = s if s_sum is None else s_sum + s
    joint_pk = BFVPublicKey(b, a)
    joint_sk_signed = np.sum([p.s_signed for p in parties], axis=0)
    joint_sk = BFVSecretKey(s_sum, joint_sk_signed)
    return parties, joint_pk, joint_sk


# NOISE_FLOODING::MP_SD (constants.h:157): each partial decryption floods
# its share with a sigma = 2^20 Gaussian so the published share leaks
# nothing about the party's secret beyond the fused result
# (base-multiparty.cpp:228-273, "e is added to do noise flooding").
MP_SD = float(1 << 20)


def _flooding_term(cc: BFVContext) -> DCRTPoly:
    from .bgv import BGVContext
    from .dcrt import DCRTPoly as _P
    ns = cc.params.t if isinstance(cc, BGVContext) else 1   # NoiseScale
    if not isinstance(cc, BGVContext):
        # BFV: total flooding across parties must stay under Delta/2 = Q/2t
        assert 16 * MP_SD * cc.params.t < cc.params.Q, \
            "flooding noise would overwhelm the BFV scaling factor Q/t"
    e = cc.rng.flooding_gaussian_signed(cc.params.N, MP_SD)
    poly = _P.from_signed(cc.params.dcrt, e, eval_form=True)
    return poly.mul_scalar(ns) if ns != 1 else poly


def multiparty_decrypt_lead(cc: BFVContext, sk: BFVSecretKey,
                            ct: BFVCiphertext) -> DCRTPoly:
    """Lead party's partial decryption c0 + c1*s_lead + ns*e_flood with the
    sigma = MP_SD flooding Gaussian (MultipartyDecryptLead,
    base-multiparty.cpp:228-249)."""
    return ct.polys[0] + ct.polys[1] * sk.s + _flooding_term(cc)


def multiparty_decrypt_main(cc: BFVContext, sk: BFVSecretKey,
                            ct: BFVCiphertext) -> DCRTPoly:
    """Non-lead partial decryption c1*s_i + ns*e_flood
    (MultipartyDecryptMain, base-multiparty.cpp:251-273)."""
    return ct.polys[1] * sk.s + _flooding_term(cc)


def multiparty_decrypt_fusion(cc: BFVContext, shares: list) -> np.ndarray:
    """Combine partial decryptions and round t/Q (MultipartyDecryptFusion)."""
    acc = shares[0]
    for s in shares[1:]:
        acc = acc + s
    v = acc.to_centered_bigint()
    Q, t = cc.params.Q, cc.params.t
    return np.array([((2 * t * c + Q) // (2 * Q)) % t for c in v], dtype=np.int64)
