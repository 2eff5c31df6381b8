"""BFVrns: exact Brakerski/Fan-Vercauteren scheme over DCRT polynomials.

Port of `tfhe_tpu/pke/bfv.py`, the host base that BGV subclasses, and the
single home of `_negacyclic_bigint`, the exact product `pke/ckks.py` uses
too. The counterpart of the reference's `src/pke/lib/scheme/bfvrns` + the
scheme-agnostic CryptoContext front-end (`cryptocontext.cpp`): parameter
generation, key generation, encrypt/decrypt, EvalAdd/Sub/Negate, EvalMult
with relinearization, for power-of-two cyclotomics.

Design notes (exactness-first; SURVEY.md §7.1):
- Residue towers are uniform per-limb samples — by CRT that IS a uniform
  element of R_Q, no big-int sampling needed.
- The EvalMult tensor product is computed EXACTLY over the integers by CRT
  convolution: both operands are centered to big-int coefficient form,
  reduced modulo an extended prime basis with capacity > N * (Q/2)^2 * 4,
  multiplied limb-wise in the evaluation domain (native-NTT accelerated),
  interpolated back, and scale-rounded by t/Q — the textbook BFV product
  with none of the HPS/BEHZ approximation error terms.
- Relinearization uses base-2^w digit decomposition of the degree-2
  component against an rlk encrypting T^d * s^2.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.rng import BinFHERng
from ..ref import ntt as ref_ntt
from ..ref import modmath
from .dcrt import DCRTParams, DCRTPoly, _moduli_chain


@dataclass(frozen=True)
class BFVParams:
    N: int
    t: int                      # plaintext modulus
    dcrt: DCRTParams
    std: float = 3.19
    relin_window: int = 16      # base-2^w gadget for relinearization

    @property
    def Q(self) -> int:
        return self.dcrt.Q

    @property
    def delta(self) -> int:
        return self.Q // self.t

    @classmethod
    def create(cls, N: int = 4096, t: int = 257, mult_depth: int = 1,
               limb_bits: int = 54) -> "BFVParams":
        """Chain length scales with depth (one extra 54-bit limb per level,
        mirroring the reference's parameter generation heuristics,
        bfvrns-parametergeneration.cpp)."""
        L = mult_depth + 1
        return cls(N=N, t=t, dcrt=DCRTParams.create(N, L, limb_bits))


@dataclass
class BFVCiphertext:
    polys: list              # list[DCRTPoly], degree = len-1, EVAL form
    params: BFVParams
    noise_deg: int = 1       # mod-reduces owed (the BGV auto-scaling layer's
                             # NoiseScaleDeg; unused by plain BFV)

    def copy(self) -> "BFVCiphertext":
        return BFVCiphertext([p.copy() for p in self.polys], self.params,
                             self.noise_deg)


@dataclass
class BFVSecretKey:
    s: DCRTPoly               # EVAL form
    s_signed: np.ndarray      # ternary coefficients


@dataclass
class BFVPublicKey:
    b: DCRTPoly               # EVAL: -(a*s + e)
    a: DCRTPoly


@dataclass
class BFVRelinKey:
    b: list = field(default_factory=list)   # per digit d: -(a_d*s + e_d) + T^d s^2
    a: list = field(default_factory=list)


class BFVContext:
    """CryptoContext analogue for BFV (gen-cryptocontext.h / cryptocontext.cpp)."""

    def __init__(self, params: BFVParams, seed: int | None = None):
        self.params = params
        self.rng = BinFHERng(seed)

    # -- sampling -------------------------------------------------------------

    def _uniform(self) -> DCRTPoly:
        p = self.params.dcrt
        rns = np.stack([self.rng.discrete_uniform(p.N, m) for m in p.moduli])
        return DCRTPoly(p, rns.astype(np.uint64), eval_form=False).to_eval()

    def _gaussian(self) -> DCRTPoly:
        e = self.rng.discrete_gaussian_signed(self.params.N, self.params.std)
        return DCRTPoly.from_signed(self.params.dcrt, e, eval_form=True)

    def _ternary(self) -> tuple[DCRTPoly, np.ndarray]:
        v = self.rng.ternary_uniform_signed(self.params.N)
        return DCRTPoly.from_signed(self.params.dcrt, v, eval_form=True), v

    # -- keys -----------------------------------------------------------------

    def key_gen(self) -> tuple[BFVSecretKey, BFVPublicKey]:
        s, s_signed = self._ternary()
        a = self._uniform()
        e = self._gaussian()
        b = -(a * s + e)
        return BFVSecretKey(s, s_signed), BFVPublicKey(b, a)

    def relin_key_gen(self, sk: BFVSecretKey) -> BFVRelinKey:
        T = 1 << self.params.relin_window
        n_digits = (self.params.Q.bit_length() + self.params.relin_window - 1) \
            // self.params.relin_window
        s2 = sk.s * sk.s
        rlk = BFVRelinKey()
        for d in range(n_digits):
            a_d = self._uniform()
            e_d = self._gaussian()
            rlk.b.append(-(a_d * sk.s + e_d) + s2.mul_scalar(pow(T, d, self.params.Q)))
            rlk.a.append(a_d)
        return rlk

    # -- encryption -------------------------------------------------------------

    def encrypt(self, pk: BFVPublicKey, m) -> BFVCiphertext:
        """m: integer array [N] mod t."""
        p = self.params
        m_arr = np.zeros(p.N, dtype=np.int64)
        m_in = np.asarray(m, dtype=np.int64)
        m_arr[:m_in.size] = m_in % p.t
        dm = DCRTPoly.from_bigint(p.dcrt, [int(x) * p.delta for x in m_arr]).to_eval()
        u, _ = self._ternary()
        e1, e2 = self._gaussian(), self._gaussian()
        c0 = pk.b * u + e1 + dm
        c1 = pk.a * u + e2
        return BFVCiphertext([c0, c1], p)

    def decrypt(self, sk: BFVSecretKey, ct: BFVCiphertext) -> np.ndarray:
        p = self.params
        acc = ct.polys[0]
        s_pow = sk.s
        for c in ct.polys[1:]:
            acc = acc + c * s_pow
            s_pow = s_pow * sk.s
        v = acc.to_centered_bigint()
        Q, t = p.Q, p.t
        out = [((2 * t * c + Q) // (2 * Q)) % t for c in v]  # round(t*c/Q) mod t
        return np.array(out, dtype=np.int64)

    # -- homomorphic ops -----------------------------------------------------------

    def eval_add(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        k = max(len(a.polys), len(b.polys))
        out = []
        for i in range(k):
            if i < len(a.polys) and i < len(b.polys):
                out.append(a.polys[i] + b.polys[i])
            else:
                out.append((a.polys[i] if i < len(a.polys) else b.polys[i]).copy())
        return BFVCiphertext(out, a.params)

    def eval_sub(self, a: BFVCiphertext, b: BFVCiphertext) -> BFVCiphertext:
        neg = BFVCiphertext([-pp for pp in b.polys], b.params)
        return self.eval_add(a, neg)

    def eval_negate(self, a: BFVCiphertext) -> BFVCiphertext:
        return BFVCiphertext([-pp for pp in a.polys], a.params)

    def eval_mult(self, a: BFVCiphertext, b: BFVCiphertext,
                  rlk: BFVRelinKey | None = None) -> BFVCiphertext:
        """Exact tensor product + t/Q scale-round (+ relinearization)."""
        p = self.params
        assert len(a.polys) == 2 and len(b.polys) == 2, "relinearize inputs first"
        ca = [x.to_centered_bigint() for x in a.polys]
        cb = [x.to_centered_bigint() for x in b.polys]
        d0 = _negacyclic_bigint(ca[0], cb[0], p)
        d1_a = _negacyclic_bigint(ca[0], cb[1], p)
        d1_b = _negacyclic_bigint(ca[1], cb[0], p)
        d1 = [x + y for x, y in zip(d1_a, d1_b)]
        d2 = _negacyclic_bigint(ca[1], cb[1], p)
        Q, t = p.Q, p.t

        def scale(coeffs):
            # round(t * c / Q) mod Q, c exact integer
            out = [((2 * t * c + Q) // (2 * Q)) % Q for c in coeffs]
            return DCRTPoly.from_bigint(p.dcrt, out).to_eval()

        polys = [scale(d0), scale(d1), scale(d2)]
        ct = BFVCiphertext(polys, p)
        return self.relinearize(ct, rlk) if rlk is not None else ct

    # -- packed (SIMD) encoding + rotations ---------------------------------------

    def encrypt_packed(self, pk: BFVPublicKey, values) -> BFVCiphertext:
        """Slot-wise encryption (packedencoding.cpp): requires prime
        t = 1 mod 2N; ring multiplication then acts slot-wise."""
        from . import encoding
        p = self.params
        coeffs = encoding.pack(values, p.t, p.N)
        dm = DCRTPoly.from_bigint(p.dcrt,
                                  [int(c) * p.delta for c in coeffs]).to_eval()
        u, _ = self._ternary()
        e1, e2 = self._gaussian(), self._gaussian()
        return BFVCiphertext([pk.b * u + e1 + dm, pk.a * u + e2], p)

    def decrypt_packed(self, sk: BFVSecretKey, ct: BFVCiphertext) -> np.ndarray:
        from . import encoding
        coeffs = self.decrypt(sk, ct)
        return encoding.unpack(coeffs, self.params.t, self.params.N)

    def galois_key_gen(self, sk: BFVSecretKey, steps: int):
        """Key-switch key for the slot-rotation automorphism X -> X^(5^steps)
        (keyswitch-bv.cpp semantics with a base-2^w gadget)."""
        from . import encoding
        p = self.params
        k = encoding.rotation_automorphism_index(p.N, steps)
        s_tau = _automorph(sk.s, k)
        T = 1 << p.relin_window
        n_digits = (p.Q.bit_length() + p.relin_window - 1) // p.relin_window
        gk = BFVRelinKey()
        for d in range(n_digits):
            a_d = self._uniform()
            e_d = self._gaussian()
            gk.b.append(-(a_d * sk.s + e_d) + s_tau.mul_scalar(pow(T, d, p.Q)))
            gk.a.append(a_d)
        return k, gk

    def eval_rotate(self, ct: BFVCiphertext, galois_key) -> BFVCiphertext:
        """Rotate packed slots: apply the automorphism to the ciphertext, then
        key-switch s(X^k) back to s (base-scheme EvalAutomorphism flow)."""
        k, gk = galois_key
        p = self.params
        assert len(ct.polys) == 2
        c0t = _automorph(ct.polys[0], k)
        c1t = _automorph(ct.polys[1], k)
        c1_big = c1t.to_bigint()
        T = 1 << p.relin_window
        c0, c1 = c0t, DCRTPoly.zero(p.dcrt, eval_form=True)
        for d in range(len(gk.b)):
            digit = [(c >> (p.relin_window * d)) & (T - 1) for c in c1_big]
            dp = DCRTPoly.from_bigint(p.dcrt, digit).to_eval()
            c0 = c0 + gk.b[d] * dp
            c1 = c1 + gk.a[d] * dp
        return BFVCiphertext([c0, c1], p)

    def relinearize(self, ct: BFVCiphertext, rlk) -> BFVCiphertext:
        if len(ct.polys) == 2:
            return ct
        assert len(ct.polys) == 3
        p = self.params
        from .keyswitch import HybridKSKey, hybrid_key_switch
        if isinstance(rlk, HybridKSKey):
            d0, d1 = hybrid_key_switch(rlk, ct.polys[2], p.dcrt)
            return BFVCiphertext([ct.polys[0] + d0, ct.polys[1] + d1], p)
        T = 1 << p.relin_window
        c2 = ct.polys[2].to_bigint()                 # in [0, Q)
        c0, c1 = ct.polys[0], ct.polys[1]
        for d in range(len(rlk.b)):
            digit = [(c >> (p.relin_window * d)) & (T - 1) for c in c2]
            dp = DCRTPoly.from_bigint(p.dcrt, digit).to_eval()
            c0 = c0 + rlk.b[d] * dp
            c1 = c1 + rlk.a[d] * dp
        return BFVCiphertext([c0, c1], p)


def _automorph(poly: DCRTPoly, k: int) -> DCRTPoly:
    """a(X) -> a(X^k) limb-wise (AutomorphismTransform, poly.cpp:664-759)."""
    from . import encoding
    p = poly.to_coeff()
    rns = np.stack([encoding.apply_automorphism_coeff(p.rns[i], k, m)
                    for i, m in enumerate(p.params.moduli)])
    return DCRTPoly(p.params, rns, eval_form=False).to_eval()


def _negacyclic_bigint(ca: list, cb: list, p: BFVParams) -> list:
    """Exact negacyclic convolution of centered big-int coefficient vectors
    via CRT-NTT over an extended prime basis (capacity > 2*N*(Q/2)^2)."""
    N = p.N
    bound = 4 * N * (p.Q // 2 + 1) ** 2
    bits = 50
    n_primes = (bound.bit_length() + bits - 1) // bits + 1
    primes = _moduli_chain(N, n_primes, bits, skip=0)
    P = 1
    for q in primes:
        P *= q
    assert P > 2 * bound

    res = []
    for q in primes:
        ra = np.array([c % q for c in ca], dtype=np.uint64)
        rb = np.array([c % q for c in cb], dtype=np.uint64)
        prod = ref_ntt.inverse(
            modmath.mul(ref_ntt.forward(ra, q), ref_ntt.forward(rb, q), q), q)
        res.append(prod)

    # CRT interpolate to exact centered integers
    facs = []
    for q in primes:
        Pi = P // q
        facs.append((Pi * pow(Pi % q, -1, q)) % P)
    out = []
    for j in range(N):
        v = 0
        for i in range(len(primes)):
            v += int(res[i][j]) * facs[i]
        v %= P
        out.append(v - P if v > P // 2 else v)
    return out
