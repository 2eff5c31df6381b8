"""BGVrns: Brakerski-Gentry-Vaikuntanathan scheme over DCRT polynomials.

Port of `tfhe_tpu/pke/bgv.py`, the counterpart of the reference's
`src/pke/lib/scheme/bgvrns`. BGV places the plaintext in the LOW bits
(noise scaled by t) where BFV scales the message by Delta = Q/t; EvalMult
is the exact tensor product (no rescale needed at small depth; modulus
switching for deeper circuits arrives with the scheme's leveled API).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bfv import BFVParams, BFVCiphertext, BFVSecretKey, BFVPublicKey, \
    BFVRelinKey, BFVContext, _negacyclic_bigint
from .dcrt import DCRTPoly


@dataclass(frozen=True)
class BGVParams(BFVParams):

    @classmethod
    def create(cls, N: int = 4096, t: int = 257, mult_depth: int = 1,
               limb_bits: int = 54) -> "BGVParams":
        """BGV chains require q_i = 1 (mod t) so modulus switching preserves
        the message (bgvrns-parametergeneration.cpp)."""
        from .dcrt import DCRTParams
        L = mult_depth + 1
        return cls(N=N, t=t,
                   dcrt=DCRTParams.create(N, L, limb_bits, extra_mod=t))


class BGVContext(BFVContext):
    """CryptoContext analogue for BGV; shares sampling/keygen machinery with
    BFV (the reference's scheme hierarchy does the same through
    schemebase/base-scheme.cpp)."""

    def key_gen(self):
        s, s_signed = self._ternary()
        a = self._uniform()
        e = self._gaussian()
        b = -(a * s + e.mul_scalar(self.params.t))
        return BFVSecretKey(s, s_signed), BFVPublicKey(b, a)

    def relin_key_gen(self, sk):
        T = 1 << self.params.relin_window
        n_digits = (self.params.Q.bit_length() + self.params.relin_window - 1) \
            // self.params.relin_window
        s2 = sk.s * sk.s
        rlk = BFVRelinKey()
        for d in range(n_digits):
            a_d = self._uniform()
            e_d = self._gaussian()
            rlk.b.append(-(a_d * sk.s + e_d.mul_scalar(self.params.t))
                         + s2.mul_scalar(pow(T, d, self.params.Q)))
            rlk.a.append(a_d)
        return rlk

    def encrypt(self, pk, m) -> BFVCiphertext:
        p = self.params
        m_arr = np.zeros(p.N, dtype=np.int64)
        m_in = np.asarray(m, dtype=np.int64)
        m_arr[:m_in.size] = m_in % p.t
        dm = DCRTPoly.from_signed(p.dcrt, m_arr, eval_form=True)
        u, _ = self._ternary()
        e1, e2 = self._gaussian(), self._gaussian()
        c0 = pk.b * u + e1.mul_scalar(p.t) + dm
        c1 = pk.a * u + e2.mul_scalar(p.t)
        return BFVCiphertext([c0, c1], p)

    def decrypt(self, sk, ct) -> np.ndarray:
        p = self.params
        lp = ct.polys[0].params
        s = (sk.s if lp.moduli == p.dcrt.moduli
             else DCRTPoly.from_signed(lp, sk.s_signed, eval_form=True))
        acc = ct.polys[0]
        s_pow = s
        for c in ct.polys[1:]:
            acc = acc + c * s_pow
            s_pow = s_pow * s
        v = acc.to_centered_bigint()
        return np.array([c % p.t for c in v], dtype=np.int64)

    def encrypt_packed(self, pk, values) -> BFVCiphertext:
        """Slot-wise (SIMD) encryption: pack then BGV-encrypt the coefficient
        vector (packedencoding.cpp; requires prime t = 1 mod 2N)."""
        from . import encoding
        return self.encrypt(pk, encoding.pack(values, self.params.t,
                                              self.params.N))

    def decrypt_packed(self, sk, ct) -> np.ndarray:
        from . import encoding
        return encoding.unpack(self.decrypt(sk, ct), self.params.t,
                               self.params.N)

    def galois_key_gen(self, sk, steps: int):
        """BGV slot-rotation key: same automorphism gadget as BFV but with
        t-scaled key noise (BGV errors live in the t multiples)."""
        from . import encoding
        from .bfv import BFVRelinKey, _automorph
        p = self.params
        k = encoding.rotation_automorphism_index(p.N, steps)
        s_tau = _automorph(sk.s, k)
        T = 1 << p.relin_window
        n_digits = (p.Q.bit_length() + p.relin_window - 1) // p.relin_window
        gk = BFVRelinKey()
        for d in range(n_digits):
            a_d = self._uniform()
            e_d = self._gaussian()
            gk.b.append(-(a_d * sk.s + e_d.mul_scalar(p.t))
                        + s_tau.mul_scalar(pow(T, d, p.Q)))
            gk.a.append(a_d)
        return k, gk

    def mod_switch(self, ct):
        """BGV modulus switching (ModReduce, rns-leveledshe.cpp): drop the
        last RNS limb, scaling the ciphertext by 1/q_last while preserving
        the message mod t — the correction r is chosen with r = c (mod
        q_last) and r = c*(1 - q_last) (mod t), so c' = (c - r)/q_last is an
        integer with c' = c (mod t) and noise shrunk by ~q_last."""
        from .bfv import BFVCiphertext
        p = self.params
        lp = ct.polys[0].params
        assert lp.L > 1, "no limbs left to switch away"
        q_last = lp.moduli[-1]
        from .dcrt import DCRTParams
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])
        t = p.t
        ql_inv_t = pow(q_last % t, -1, t)
        out = []
        for poly in ct.polys:
            c = poly.to_centered_bigint()
            coeffs = []
            for x in c:
                r0 = x % q_last
                if r0 > q_last // 2:
                    r0 -= q_last
                # delta in [-t/2, t/2): r = r0 + q_last*delta = x(1-q_last) mod t
                delta = ((x * (1 - q_last) - r0) * ql_inv_t) % t
                if delta > t // 2:
                    delta -= t
                r = r0 + q_last * delta
                coeffs.append(((x - r) // q_last) % new_lp.Q)
            out.append(DCRTPoly.from_bigint(new_lp, coeffs).to_eval())
        return BFVCiphertext(out, p)

    def eval_mult(self, a, b, rlk=None) -> BFVCiphertext:
        """Exact tensor product (no BFV t/Q rescale — BGV noise is additive in
        the t-scaled error)."""
        p = self.params
        assert len(a.polys) == 2 and len(b.polys) == 2
        ca = [x.to_centered_bigint() for x in a.polys]
        cb = [x.to_centered_bigint() for x in b.polys]
        d0 = _negacyclic_bigint(ca[0], cb[0], p)
        d1a = _negacyclic_bigint(ca[0], cb[1], p)
        d1b = _negacyclic_bigint(ca[1], cb[0], p)
        d1 = [x + y for x, y in zip(d1a, d1b)]
        d2 = _negacyclic_bigint(ca[1], cb[1], p)
        Q = p.Q

        def tower(coeffs):
            return DCRTPoly.from_bigint(p.dcrt, [c % Q for c in coeffs]).to_eval()

        ct = BFVCiphertext([tower(d0), tower(d1), tower(d2)], p)
        return self.relinearize(ct, rlk) if rlk is not None else ct
