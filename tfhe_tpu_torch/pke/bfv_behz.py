"""Pure-RNS BFV multiplication, BEHZ variant (Bajard-Eynard-Hasan-Zucca).

Port of `tfhe_tpu/pke/bfv_behz.py`, line for line.

The reference selects between two RNS multiplication techniques for BFV
(`constants.h MultiplicationTechnique {BEHZ, HPS, ...}`;
`bfvrns-leveledshe.cpp:265-405`). HPS lives in pke/bfv_rns.py; this module
is the BEHZ pipeline — the all-INTEGER variant, with no fractional
fixed-point rounding anywhere:

  1. `fast_base_conv_q_to_bsk` — lift into the auxiliary basis
     Bsk = B ∪ {m_sk} via the small-Montgomery trick (dcrtpoly.cpp
     FastBaseConvqToBskMontgomery): convert |x·m̃|_Q approximately (error
     u·Q, 0 ≤ u < L), cancel it with r = -conv·Q^{-1} mod m̃ = 2^16
     (centered; m̃ > 2L makes the recovery unambiguous), divide by m̃.
     The result is the representative x or x−Q — inside (−Q, Q), which is
     all the BEHZ tensor product needs (the ±Q slack scales to an exact
     multiple of t through the floor and vanishes mod t at decryption,
     costing only noise — the paper's ρ term).
  2. Tensor product limb-wise over BOTH bases Q and Bsk (NTT per limb);
     Q·B·m_sk > 2·N·Q²·t holds the integer product of the [0,Q) reps.
  3. `fast_rns_floor_q` — floor(t·x/Q) in basis Bsk with additive error
     in [0, L): convert |t·x|_Q approximately into Bsk (folding the Q^{-1}
     through the Q-hat identity Σ y_i·(Q/q_i)·Q^{-1} = Σ y_i·q_i^{-1}),
     subtract from t·x·Q^{-1} (dcrtpoly.cpp FastRNSFloorq).
  4. `fast_base_conv_sk` — Shenoy-Kumaresan EXACT conversion Bsk → Q:
     the spare channel m_sk measures the B-overflow multiple
     α = (FastConv_B(x) − x) · B^{-1} mod m_sk (centered), which is then
     subtracted in basis Q (dcrtpoly.cpp FastBaseConvSK).
  5. Relinearization by the shared pure-RNS hybrid key switch.

Every step is 32-bit-word modular arithmetic on sub-2^31 limbs — the same
discipline as the HPS module but with NO _fp_round_dot fixed point at all,
which is why BEHZ is the natural device pipeline (pke/bfv_behz_device.py
runs it bit-identically). The price is the BEHZ noise term: the floor's
[0, L) error and the non-centered representatives add O(L·t) rounding
noise per mult vs HPS's exact centered rounding (the same trade the
reference documents).

Basis sizing mirrors bfvrns-cryptoparameters.cpp:665-712: numb = L limbs
of the chain's width for B, plus m_sk, grown until Q·B·m_sk > 2·N·Q²·t.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ref import modmath
from .bfv import BFVCiphertext, BFVContext
from .bfv_rns import BFVRnsContext
from .ckks_rns import rns_hybrid_key_switch
from .dcrt import DCRTParams, DCRTPoly, _moduli_chain

MTILDE_BITS = 16
MTILDE = 1 << MTILDE_BITS


def choose_bsk_moduli(N: int, q_mods: tuple, t: int) -> tuple:
    """B ∪ {m_sk}: L same-width NTT primes (disjoint from Q and from the
    HPS R chain) plus one spare, grown until Q·B·m_sk > 2·N·Q²·t — the
    maxConvolutionValue bound of bfvrns-cryptoparameters.cpp:677."""
    bits = max(m.bit_length() for m in q_mods)
    Q = 1
    for q in q_mods:
        Q *= q
    L = len(q_mods)
    avoid = set(q_mods)
    numb = L
    while True:
        # over-generate and drop any prime the Q chain already uses
        # (distinctness from Q is the only requirement; sharing primes with
        # the unused-by-BEHZ HPS R basis would be sound)
        cand = [p for p in _moduli_chain(N, numb + 1 + len(avoid), bits)
                if p not in avoid][:numb + 1]
        prod = 1
        for b in cand:
            prod *= b
        if Q * prod > 2 * N * Q * Q * t:
            return tuple(cand)
        numb += 1


@lru_cache(maxsize=None)
def _behz_tables(q_mods: tuple, bsk_mods: tuple, t: int):
    """All BEHZ constant tables (the m_* members of BFVCryptoParametersRNS's
    BEHZ branch), as numpy arrays keyed by the two bases and t."""
    Q = 1
    for q in q_mods:
        Q *= q
    b_mods = bsk_mods[:-1]
    msk = bsk_mods[-1]
    B = 1
    for b in b_mods:
        B *= b
    qhat = [Q // q for q in q_mods]
    # lift (step 1)
    mtilde_qhatinv_q = np.array(
        [(MTILDE * pow(qhat[i] % q, -1, q)) % q
         for i, q in enumerate(q_mods)], dtype=np.uint64)
    qhat_bsk = np.array([[qh % m for qh in qhat] for m in bsk_mods],
                        dtype=np.uint64)                       # [bsk, L]
    qhat_mtilde = np.array([qh % MTILDE for qh in qhat], dtype=np.uint64)
    neg_qinv_mtilde = np.uint64((-pow(Q % MTILDE, -1, MTILDE)) % MTILDE)
    q_bsk = np.array([Q % m for m in bsk_mods], dtype=np.uint64)
    mtilde_inv_bsk = np.array([pow(MTILDE, -1, m) for m in bsk_mods],
                              dtype=np.uint64)
    # floor (step 3)
    t_qhatinv_q = np.array([(t * pow(qhat[i] % q, -1, q)) % q
                            for i, q in enumerate(q_mods)], dtype=np.uint64)
    qinv_bsk = np.array([[pow(q % m, -1, m) for q in q_mods]
                         for m in bsk_mods], dtype=np.uint64)  # [bsk, L]
    t_qinv_bsk = np.array([(t * pow(Q % m, -1, m)) % m for m in bsk_mods],
                          dtype=np.uint64)
    # Shenoy-Kumaresan (step 4)
    bhat = [B // b for b in b_mods]
    bhatinv_b = np.array([pow(bhat[j] % b, -1, b)
                          for j, b in enumerate(b_mods)], dtype=np.uint64)
    bhat_q = np.array([[bh % q for bh in bhat] for q in q_mods],
                      dtype=np.uint64)                         # [L, numb]
    bhat_msk = np.array([bh % msk for bh in bhat], dtype=np.uint64)
    binv_msk = np.uint64(pow(B % msk, -1, msk))
    b_mod_q = np.array([B % q for q in q_mods], dtype=np.uint64)
    return (mtilde_qhatinv_q, qhat_bsk, qhat_mtilde, neg_qinv_mtilde,
            q_bsk, mtilde_inv_bsk, t_qhatinv_q, qinv_bsk, t_qinv_bsk,
            bhatinv_b, bhat_q, bhat_msk, binv_msk, b_mod_q)


def fast_base_conv_q_to_bsk(rns_q: np.ndarray, q_mods: tuple,
                            bsk_mods: tuple, t: int = 2) -> np.ndarray:
    """[L, N] residues over Q -> [numb+1, N] EXACT residues of the [0, Q)
    representative over Bsk (small-Montgomery correction; BEHZ Alg. 3)."""
    (mqi, qhat_bsk, qhat_mt, neg_qinv_mt, q_bsk, mt_inv,
     *_rest) = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    L = len(q_mods)
    y = np.stack([modmath.mul(rns_q[i], mqi[i], q_mods[i])
                  for i in range(L)])                          # x*mtilde twist
    mask = np.uint64(MTILDE - 1)
    r_m = np.zeros(rns_q.shape[-1], dtype=np.uint64)
    for i in range(L):
        r_m = (r_m + (y[i] & mask) * (qhat_mt[i] & mask)) & mask
    r_m = (r_m * neg_qinv_mt) & mask                           # [N] mod 2^16
    high = r_m >= np.uint64(MTILDE // 2)
    out = []
    for j, m in enumerate(bsk_mods):
        um = np.uint64(m)
        acc = np.zeros(rns_q.shape[-1], dtype=np.uint64)
        for i in range(L):
            acc = (acc + modmath.mul(y[i] % um, qhat_bsk[j, i], m)) % um
        # centered r: subtract mtilde for the upper half (mod m)
        r = np.where(high, (r_m + um - np.uint64(MTILDE)) % um, r_m)
        acc = (acc + modmath.mul(r, q_bsk[j], m)) % um
        out.append(modmath.mul(acc, mt_inv[j], m))
    return np.stack(out)


def fast_rns_floor_q(rns_q: np.ndarray, rns_bsk: np.ndarray, q_mods: tuple,
                     bsk_mods: tuple, t: int) -> np.ndarray:
    """x over Q ∪ Bsk -> floor(t·x/Q) − u over Bsk, 0 ≤ u < L
    (dcrtpoly.cpp FastRNSFloorq; the slack lands in the mult noise)."""
    tabs = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    t_qhatinv_q, qinv_bsk, t_qinv_bsk = tabs[6], tabs[7], tabs[8]
    L = len(q_mods)
    y = np.stack([modmath.mul(rns_q[i], t_qhatinv_q[i], q_mods[i])
                  for i in range(L)])
    out = []
    for j, m in enumerate(bsk_mods):
        um = np.uint64(m)
        f = np.zeros(rns_q.shape[-1], dtype=np.uint64)
        for i in range(L):
            f = (f + modmath.mul(y[i] % um, qinv_bsk[j, i], m)) % um
        tx = modmath.mul(rns_bsk[j], t_qinv_bsk[j], m)
        out.append((tx + um - f) % um)
    return np.stack(out)


def fast_base_conv_sk(rns_bsk: np.ndarray, q_mods: tuple, bsk_mods: tuple,
                      t: int = 2) -> np.ndarray:
    """Shenoy-Kumaresan Bsk -> Q: exact for values in [0, B·m_sk/2)
    (dcrtpoly.cpp FastBaseConvSK; the spare residue mod m_sk measures the
    B-overflow count, centered at m_sk/2)."""
    tabs = _behz_tables(tuple(q_mods), tuple(bsk_mods), t)
    bhatinv_b, bhat_q, bhat_msk, binv_msk, b_mod_q = tabs[9:14]
    numb = len(bsk_mods) - 1
    msk = bsk_mods[-1]
    umsk = np.uint64(msk)
    z = np.stack([modmath.mul(rns_bsk[j], bhatinv_b[j], bsk_mods[j])
                  for j in range(numb)])
    # alpha = (FastConv_B(x) - x_msk) * B^{-1} mod msk
    w = np.zeros(rns_bsk.shape[-1], dtype=np.uint64)
    for j in range(numb):
        w = (w + modmath.mul(z[j] % umsk, bhat_msk[j], msk)) % umsk
    alpha = modmath.mul((w + umsk - rns_bsk[-1]) % umsk, binv_msk, msk)
    high = alpha > umsk // np.uint64(2)
    out = []
    for i, q in enumerate(q_mods):
        uq = np.uint64(q)
        acc = np.zeros(rns_bsk.shape[-1], dtype=np.uint64)
        for j in range(numb):
            acc = (acc + modmath.mul(z[j] % uq, bhat_q[i, j], q)) % uq
        a_c = np.where(high, (alpha % uq + uq - umsk % uq) % uq, alpha % uq)
        corr = modmath.mul(a_c, b_mod_q[i], q)
        out.append((acc + uq - corr) % uq)
    return np.stack(out)


class BFVBehzContext(BFVRnsContext):
    """BFV with the BEHZ multiplication technique. Encryption, decryption,
    keys, rotations, and additions are technique-independent and inherit
    from the HPS context (exactly the reference's structure, where
    MultiplicationTechnique only reroutes EvalMult and its precomputed
    tables); only eval_mult is the BEHZ pipeline."""

    def __init__(self, base_ctx: BFVContext, dnum: int = 2,
                 ks_limb_bits: int = 40):
        super().__init__(base_ctx, dnum=dnum, ks_limb_bits=ks_limb_bits)
        p = self.params
        self.bsk_moduli = choose_bsk_moduli(p.N, p.dcrt.moduli, p.t)
        self.bsk_params = DCRTParams(N=p.N, moduli=tuple(self.bsk_moduli))

    def eval_mult(self, a: BFVCiphertext, b: BFVCiphertext,
                  rlk=None) -> BFVCiphertext:
        """BEHZ tensor product: exact Montgomery lift into Bsk, multiply in
        Q and Bsk, t/Q floor into Bsk, Shenoy-Kumaresan back to Q,
        relinearize (bfvrns-leveledshe.cpp EvalMult, BEHZ branch)."""
        p = self.params
        lp = p.dcrt
        q_mods = tuple(lp.moduli)
        bsk = tuple(self.bsk_moduli)
        assert len(a.polys) == 2 and len(b.polys) == 2

        def lift(poly: DCRTPoly):
            c = poly.to_coeff()
            ext = fast_base_conv_q_to_bsk(c.rns, q_mods, bsk, p.t)
            return (poly,                                    # eval over Q
                    DCRTPoly(self.bsk_params, ext,
                             eval_form=False).to_eval())     # eval over Bsk

        a0, a1 = lift(a.polys[0]), lift(a.polys[1])
        b0, b1 = lift(b.polys[0]), lift(b.polys[1])

        def tensor(x, y, z=None, w=None):
            dq = x[0] * y[0]
            dbsk = x[1] * y[1]
            if z is not None:
                dq = dq + z[0] * w[0]
                dbsk = dbsk + z[1] * w[1]
            return dq, dbsk

        def scale_back(dq: DCRTPoly, dbsk: DCRTPoly) -> DCRTPoly:
            fl = fast_rns_floor_q(dq.to_coeff().rns, dbsk.to_coeff().rns,
                                  q_mods, bsk, p.t)
            back = fast_base_conv_sk(fl, q_mods, bsk, p.t)
            return DCRTPoly(lp, back, eval_form=False).to_eval()

        d0 = scale_back(*tensor(a0, b0))
        d1 = scale_back(*tensor(a0, b1, a1, b0))
        d2 = scale_back(*tensor(a1, b1))
        if rlk is None:
            return BFVCiphertext([d0, d1, d2], p)
        s0, s1 = rns_hybrid_key_switch(rlk, d2, q_mods)
        return BFVCiphertext([d0 + s0, d1 + s1], p)
