"""Pure-RNS BFV multiplication (HPS): no big-integer hot path.

Port of `tfhe_tpu/pke/bfv_rns.py`, line for line on the port's `bfv`,
`ckks_rns`, `dcrt` and `ref/modmath`.

The exactness-first host BFV (pke/bfv.py) computes the tensor product by
exact CRT interpolation over python ints — correct, but every mult leaves
the RNS domain. This module is the production-form counterpart of the
reference's `bfvrns-leveledshe.cpp` HPS multiplication pipeline
(Halevi-Polyakov-Shoup '19, the scheme OpenFHE selects by default):

  1. `expand_crt_basis` — EXACT extension of the centered representative
     from basis Q to the auxiliary basis R: y_i = [x*(Q/q_i)^-1]_{q_i},
     alpha = round(sum y_i/q_i) in 80-bit integer fixed point,
     x_r = sum y_i*(Q/q_i) - alpha*Q mod r. Unlike the approximate FBC in
     ckks_rns.py (whose +-Q slack is harmless inside key switching), BFV's
     tensor product would turn a +-Q representative error into t*(huge)
     ciphertext corruption, so the alpha rounding must be correct: the
     F=80 fixed point gives a ~2^-50 tie band around |x| = Q/2 — the
     guarantee the reference gets from its double / long-double
     `ApproxSwitchCRTBasis` path, but integer-deterministic, so the device
     code (pke/bfv_device.py) reproduces the host bit-for-bit.
  2. Tensor product limb-wise over the QR basis (NTT per limb); the product
     magnitude is < N*Q^2/2 < QR/2, so the QR residues carry it exactly.
  3. `scale_and_round` — round(t*x/Q) into basis R:
     t*x/Q = sum_{i in Q} y_i*(tR/q_i) + t*sum_{j in R} y_j*(R/r_j) - alpha*tR;
     integer parts are accumulated mod r, the fractional sum
     sum y_i*frac(tR/q_i) in 64-bit fixed point (error O(L) rounding units
     of extra noise, far under the Delta/2 decryption margin).
  4. `expand_crt_basis` again (R -> Q) to land the rounded product back in
     the working basis — exact, since |round(t*x/Q)| <= t*N*Q/2 << R/2
     keeps the rounding far from the tie band.
  5. Relinearization of d2 by the shared pure-RNS hybrid key switch
     (ckks_rns.rns_hybrid_ks_gen / rns_hybrid_key_switch with plain noise
     t=1 — BFV relin keys are CKKS-shaped).

Also pure-RNS encrypt (Delta mod q_i precomputed) and decrypt
(round(t*x/Q) mod t = round(sum y_i * t/q_i) mod t — the alpha term
vanishes mod t), so the whole BFV lifecycle stays in [L, N] residue
towers. Validated against the exact big-int BFV in tests/test_bfv_rns.py.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ref import modmath
from .bfv import BFVCiphertext, BFVContext, BFVParams
from .ckks_rns import RnsHybridKey, rns_hybrid_ks_gen, rns_hybrid_key_switch
from .dcrt import DCRTParams, DCRTPoly, _moduli_chain


# -- shared exact fixed-point rounding ---------------------------------------
#
# Everything that rounds a rational sum here — the expansion alpha, the
# scale-and-round fractional term, the decrypt scaling — is specified as
# round(sum_i y_i * floor(2^F * n_i / d_i) / 2^F) in exact 32-bit-WORD integer
# arithmetic, so the host numpy path and the int64 device code
# (pke/bfv_device.py) compute the IDENTICAL value on every input (the same
# discipline as ckks_rns.alpha_fixed_tables, at higher precision). At F=80
# with <= 30-bit limbs the per-term truncation error is < 2^-50 — the
# guarantee the reference gets from its double/long-double arithmetic
# (bfvrns-leveledshe.cpp), but bit-reproducible.

def _fp_split(numers, denoms, F: int):
    """floor(2^F * n_i / d_i) split into three 32-bit words (w0, w1, w2)."""
    t = [((int(n) << F) // int(d)) for n, d in zip(numers, denoms)]
    assert all(x < (1 << 96) for x in t)
    mask = (1 << 32) - 1
    w0 = np.array([x & mask for x in t], dtype=np.uint64)
    w1 = np.array([(x >> 32) & mask for x in t], dtype=np.uint64)
    w2 = np.array([x >> 64 for x in t], dtype=np.uint64)
    return w0, w1, w2


def _fp_round_dot(y: np.ndarray, words, F: int) -> np.ndarray:
    """round(sum_i y_i * t_i / 2^F) exactly, t_i given as 32-bit words.
    Requires y_i < 2^32 and <= ~2^26 terms (word sums stay below 2^64)."""
    w0, w1, w2 = words
    y64 = y.astype(np.uint64)
    mask = np.uint64(0xffffffff)
    p0 = y64 * w0[:, None]
    p1 = y64 * w1[:, None]
    p2 = y64 * w2[:, None]
    a0 = (p0 & mask).sum(axis=0)
    a1 = (p0 >> np.uint64(32)).sum(axis=0) + (p1 & mask).sum(axis=0)
    a2 = (p1 >> np.uint64(32)).sum(axis=0) + (p2 & mask).sum(axis=0)
    a3 = (p2 >> np.uint64(32)).sum(axis=0)
    # fold carries so each word is < 2^32; S = ((a3*2^32+a2)*2^32+a1)*2^32+a0
    a1 += a0 >> np.uint64(32)
    a0 &= mask
    a2 += a1 >> np.uint64(32)
    a1 &= mask
    a3 += a2 >> np.uint64(32)
    a2 &= mask
    # + 2^(F-1), then >> F: with 32 <= F < 96 only whole-word shifts + one
    # sub-word shift of the surviving high words are needed
    k, r = divmod(F - 1, 32)
    add = np.uint64(1 << r)
    ws = [a0, a1, a2, a3]
    ws[k] += add
    for i in range(k, 3):
        ws[i + 1] += ws[i] >> np.uint64(32)
        ws[i] &= mask
    kq, rq = divmod(F, 32)
    hi = np.zeros_like(a0)
    for i in range(3, kq - 1, -1):
        hi = (hi << np.uint64(32)) + ws[i]
    return (hi >> np.uint64(rq)).astype(np.int64)


# -- exact centered base extension -------------------------------------------

_EXPAND_F = 80


@lru_cache(maxsize=None)
def _expand_tables(src: tuple, dst: tuple):
    D = 1
    for q in src:
        D *= q
    inv = np.array([pow((D // q) % q, -1, q) for q in src], dtype=np.uint64)
    alpha_words = _fp_split([1] * len(src), src, _EXPAND_F)
    dhat_dst = np.array([[(D // q) % m for q in src] for m in dst],
                        dtype=np.uint64)
    d_dst = np.array([D % m for m in dst], dtype=np.uint64)
    return inv, alpha_words, dhat_dst, d_dst


def expand_crt_basis(rns_src: np.ndarray, src: tuple, dst: tuple) -> np.ndarray:
    """Residues over `dst` of the CENTERED representative of `rns_src`
    (value in (-D/2, D/2], D = prod(src)). Exact whenever the
    alpha = round(sum y_i/q_i) rounds on the correct side — guaranteed
    except in a ~2^-50-wide band around |x| = D/2 (the fixed-point
    equivalent of the reference's double-precision guarantee,
    bfvrns-leveledshe.cpp ExpandCRTBasis)."""
    inv, alpha_words, dhat_dst, d_dst = _expand_tables(tuple(src), tuple(dst))
    y = np.stack([modmath.mul(rns_src[i], inv[i], src[i])
                  for i in range(len(src))])             # [s, N]
    alpha = _fp_round_dot(y, alpha_words, _EXPAND_F)     # [N]
    out = []
    for j, m in enumerate(dst):
        acc = np.zeros(rns_src.shape[-1], dtype=np.uint64)
        for i in range(len(src)):
            acc = (acc + modmath.mul(y[i] % np.uint64(m), dhat_dst[j, i], m)) \
                % np.uint64(m)
        corr = modmath.mul((alpha % np.int64(m)).astype(np.uint64), d_dst[j], m)
        out.append((acc + np.uint64(m) - corr) % np.uint64(m))
    return np.stack(out)


# -- t/Q scale-and-round -----------------------------------------------------

_NU_F = 64


@lru_cache(maxsize=None)
def _scale_round_tables(q_mods: tuple, r_mods: tuple, t: int):
    D = 1
    for d in q_mods + r_mods:
        D *= d
    R = 1
    for r in r_mods:
        R *= r
    inv = np.array([pow((D // d) % d, -1, d) for d in q_mods + r_mods],
                   dtype=np.uint64)
    # integer/fractional split of t*R/q_i
    omega = [[(t * R // q) % r for q in q_mods] for r in r_mods]
    theta_words = _fp_split([t * R % q for q in q_mods], q_mods, _NU_F)
    # t*(R/r_j) mod r, and t*R mod r (the -alpha*tR correction)
    t_rhat = [[(t * (R // rj)) % r for rj in r_mods] for r in r_mods]
    t_r = [(t * R) % r for r in r_mods]
    alpha_words = _fp_split([1] * (len(q_mods) + len(r_mods)),
                            q_mods + r_mods, _EXPAND_F)
    return inv, omega, theta_words, t_rhat, t_r, alpha_words


def scale_and_round(rns_qr: np.ndarray, q_mods: tuple, r_mods: tuple,
                    t: int) -> np.ndarray:
    """[L_q + L_r, N] residues of x over the QR basis (centered value,
    |x| < QR/2) -> [L_r, N] residues of round(t*x/Q) over R
    (bfvrns-leveledshe.cpp ScaleAndRound). The fixed-point fractional
    accumulation error is O(L * 2^-34) extra rounding units — under the
    reference's double-precision bound, and bit-reproducible on device."""
    q_mods, r_mods = tuple(q_mods), tuple(r_mods)
    inv, omega, theta_words, t_rhat, t_r, alpha_words = _scale_round_tables(
        q_mods, r_mods, t)
    all_mods = q_mods + r_mods
    n_q = len(q_mods)
    y = np.stack([modmath.mul(rns_qr[k], inv[k], all_mods[k])
                  for k in range(len(all_mods))])
    alpha = _fp_round_dot(y, alpha_words, _EXPAND_F)                   # [N]
    nu = _fp_round_dot(y[:n_q], theta_words, _NU_F)
    out = []
    for j, r in enumerate(r_mods):
        ur = np.uint64(r)
        acc = np.zeros(rns_qr.shape[-1], dtype=np.uint64)
        for i in range(n_q):
            acc = (acc + modmath.mul(y[i] % ur,
                                     np.uint64(omega[j][i]), r)) % ur
        for jj in range(len(r_mods)):
            acc = (acc + modmath.mul(y[n_q + jj] % ur,
                                     np.uint64(t_rhat[j][jj]), r)) % ur
        corr = modmath.mul((alpha % np.int64(r)).astype(np.uint64),
                           np.uint64(t_r[j]), r)
        acc = (acc + ur - corr) % ur
        acc = (acc + (nu % np.int64(r)).astype(np.uint64)) % ur
        out.append(acc)
    return np.stack(out)


# -- context -----------------------------------------------------------------

class BFVRnsContext:
    """BFV with the HPS pure-RNS multiplication pipeline. Key generation
    and sampling reuse pke/bfv.py's context (already RNS-native); encrypt,
    decrypt, mult, and relinearization here never leave the residue
    domain."""

    def __init__(self, base_ctx: BFVContext, dnum: int = 2,
                 ks_limb_bits: int = 40):
        assert isinstance(base_ctx, BFVContext)
        self.ctx = base_ctx
        self.params: BFVParams = base_ctx.params
        self.dnum = dnum
        self.ks_limb_bits = ks_limb_bits
        p = self.params
        lp = p.dcrt
        assert all(m < (1 << 31) for m in lp.moduli), \
            "BFVRnsContext needs limb moduli < 2^31 (the 32-bit-word fixed " \
            "point that keeps host and device bit-identical; build the " \
            "chain with limb_bits <= 30 and add limbs for capacity)"
        bits = max(m.bit_length() for m in lp.moduli)
        # R must hold the tensor product (R > 2NQ for alpha safety) AND the
        # scaled product (|round(t*x/Q)| <= t*N*Q/2 < R/4)
        import math
        need = math.log2(4 * p.t * p.N)
        extra = max(1, int(math.ceil(need / bits)))
        self.r_moduli = _moduli_chain(lp.N, lp.L + extra, bits, skip=lp.L)
        self.qr_params = DCRTParams(N=lp.N,
                                    moduli=lp.moduli + tuple(self.r_moduli))
        self._delta_mod = tuple(int(p.delta % m) for m in lp.moduli)

    def key_gen(self):
        """Key generation is technique-independent — delegate to the base
        context (so factory-built RNS contexts are self-sufficient)."""
        return self.ctx.key_gen()

    # -- RNS encrypt / decrypt ------------------------------------------------

    def encrypt(self, pk, m) -> BFVCiphertext:
        """Delta*m computed per limb with the precomputed [Delta]_{q_i} —
        no big-int coefficient products (bfvrns encrypt)."""
        p = self.params
        lp = p.dcrt
        m_arr = np.zeros(p.N, dtype=np.int64)
        m_in = np.asarray(m, dtype=np.int64)
        m_arr[:m_in.size] = m_in % p.t
        rows = np.stack([
            modmath.mul((m_arr % np.int64(mod)).astype(np.uint64),
                        np.uint64(self._delta_mod[i]), mod)
            for i, mod in enumerate(lp.moduli)])
        dm = DCRTPoly(lp, rows, eval_form=False).to_eval()
        u, _ = self.ctx._ternary()
        e1, e2 = self.ctx._gaussian(), self.ctx._gaussian()
        return BFVCiphertext([pk.b * u + e1 + dm, pk.a * u + e2], p)

    def encrypt_packed(self, pk, values) -> BFVCiphertext:
        from . import encoding
        return self.encrypt(pk, encoding.pack(values, self.params.t,
                                              self.params.N))

    def decrypt(self, sk, ct: BFVCiphertext) -> np.ndarray:
        """round(t*x/Q) mod t = round(sum_i y_i*t/q_i) mod t: the alpha*t
        term vanishes mod t, so no alpha at all (bfvrns decrypt's
        ScaleAndRound to the single modulus t)."""
        p = self.params
        acc = ct.polys[0]
        s_pow = sk.s
        for c in ct.polys[1:]:
            acc = acc + c * s_pow
            s_pow = s_pow * sk.s
        x = acc.to_coeff()
        lp = p.dcrt
        inv, _, _, _ = _expand_tables(tuple(lp.moduli), (int(p.t),))
        y = np.stack([modmath.mul(x.rns[i], inv[i], m)
                      for i, m in enumerate(lp.moduli)])
        words = _fp_split([p.t] * lp.L, lp.moduli, _NU_F)
        f = _fp_round_dot(y, words, _NU_F)
        return f % p.t

    def decrypt_packed(self, sk, ct) -> np.ndarray:
        from . import encoding
        return encoding.unpack(self.decrypt(sk, ct), self.params.t,
                               self.params.N)

    # -- keys -----------------------------------------------------------------

    def relin_key_gen(self, sk) -> RnsHybridKey:
        from .keyswitch import negacyclic_square_signed
        return rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            negacyclic_square_signed(sk.s_signed), sk.s_signed,
            self.dnum, limb_bits=self.ks_limb_bits)

    def galois_key_gen(self, sk, steps: int) -> RnsHybridKey:
        from .encoding import rotation_automorphism_index
        from .keyswitch import automorph_signed
        k = rotation_automorphism_index(self.params.N, steps)
        key = rns_hybrid_ks_gen(
            self.ctx.rng, self.params.dcrt,
            automorph_signed(sk.s_signed, k), sk.s_signed,
            self.dnum, limb_bits=self.ks_limb_bits)
        key.galois_k = k
        return key

    # -- homomorphic ops -------------------------------------------------------

    def eval_add(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        return BFVCiphertext([x + y for x, y in zip(a.polys, b.polys)],
                             a.params)

    def eval_mult_plain(self, ct: BFVCiphertext, values) -> BFVCiphertext:
        """Slotwise multiply by an unencrypted packed vector (EvalMult's
        plaintext overload): Delta*m*pt + e*pt — ring-multiply both polys
        by the packed plaintext, no relinearization or scaling needed."""
        from .dcrt import DCRTPoly
        from .encoding import pack
        lp = ct.polys[0].params
        coeffs = pack(values, self.params.t, self.params.N)
        pt = DCRTPoly.from_signed(lp, np.asarray(coeffs, dtype=np.int64),
                                  eval_form=True)
        return BFVCiphertext([p * pt for p in ct.polys], ct.params)

    def eval_mult(self, a: BFVCiphertext, b: BFVCiphertext,
                  rlk: RnsHybridKey | None = None) -> BFVCiphertext:
        """HPS tensor product: expand to QR, multiply, t/Q-scale-round into
        R, switch back to Q, relinearize — all in RNS."""
        p = self.params
        lp = p.dcrt
        q_mods = tuple(lp.moduli)
        r_mods = tuple(self.r_moduli)
        qr = self.qr_params
        assert len(a.polys) == 2 and len(b.polys) == 2

        def lift(poly: DCRTPoly) -> DCRTPoly:
            c = poly.to_coeff()
            ext = expand_crt_basis(c.rns, q_mods, r_mods)
            return DCRTPoly(qr, np.concatenate([c.rns, ext]),
                            eval_form=False).to_eval()

        a0, a1 = lift(a.polys[0]), lift(a.polys[1])
        b0, b1 = lift(b.polys[0]), lift(b.polys[1])
        d0 = a0 * b0
        d1 = a0 * b1 + a1 * b0
        d2 = a1 * b1

        def scale_back(d: DCRTPoly) -> DCRTPoly:
            rows_r = scale_and_round(d.to_coeff().rns, q_mods, r_mods, p.t)
            back = expand_crt_basis(rows_r, r_mods, q_mods)
            return DCRTPoly(lp, back, eval_form=False).to_eval()

        polys = [scale_back(d0), scale_back(d1), scale_back(d2)]
        if rlk is None:
            return BFVCiphertext(polys, p)
        s0, s1 = rns_hybrid_key_switch(rlk, polys[2], q_mods)
        return BFVCiphertext([polys[0] + s0, polys[1] + s1], p)

    def eval_rotate(self, ct: BFVCiphertext, steps: int,
                    gk: RnsHybridKey) -> BFVCiphertext:
        """Packed slot rotation: automorphism + pure-RNS hybrid key switch
        (vs pke/bfv.py's big-int gadget digits)."""
        from .encoding import (apply_automorphism_coeff,
                               rotation_automorphism_index)
        k = rotation_automorphism_index(self.params.N, steps)
        lp = ct.polys[0].params

        def auto(poly: DCRTPoly) -> DCRTPoly:
            c = poly.to_coeff()
            rows = np.stack([apply_automorphism_coeff(c.rns[i], k, m)
                             for i, m in enumerate(lp.moduli)])
            return DCRTPoly(lp, rows, eval_form=False).to_eval()

        c0a, c1a = auto(ct.polys[0]), auto(ct.polys[1])
        d0, d1 = rns_hybrid_key_switch(gk, c1a, lp.moduli)
        return BFVCiphertext([c0a + d0, d1], ct.params)
