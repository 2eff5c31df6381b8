"""CKKSrns: approximate-arithmetic scheme over DCRT polynomials.

Port of `tfhe_tpu/pke/ckks.py`, the counterpart of the reference's
`src/pke/lib/scheme/ckksrns` (encode/decode via the canonical embedding,
encrypt/decrypt, EvalAdd, EvalMult + rescale). The embedding uses one 2N-th
primitive root per conjugate pair (slots = N/2); the tensor product is exact
(CRT-NTT, `bfv._negacyclic_bigint`) and rescaling drops the last RNS limb,
dividing the scale by it — the textbook RNS-CKKS flow.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..utils.rng import BinFHERng
from .bfv import _negacyclic_bigint
from .dcrt import DCRTParams, DCRTPoly


@dataclass(frozen=True)
class CKKSParams:
    N: int
    dcrt: DCRTParams
    scale: float              # default encoding scale Delta
    std: float = 3.19
    relin_window: int = 16

    @property
    def Q(self) -> int:
        return self.dcrt.Q

    @property
    def slots(self) -> int:
        return self.N // 2

    @classmethod
    def create(cls, N: int = 2048, mult_depth: int = 1,
               scale_bits: int = 40, limb_bits: int = 54) -> "CKKSParams":
        L = mult_depth + 1
        return cls(N=N, dcrt=DCRTParams.create(N, L, limb_bits),
                   scale=float(1 << scale_bits))


@dataclass
class CKKSCiphertext:
    polys: list               # DCRTPoly (EVAL), possibly at a reduced chain
    scale: float
    params: CKKSParams
    noise_deg: int = 1        # 1 = rescaled, 2 = holds one deferred rescale
                              # (the reference's NoiseScaleDeg, used by the
                              # automatic scaling techniques in ckks_auto.py)

    @property
    def level_params(self) -> DCRTParams:
        return self.polys[0].params


@lru_cache(maxsize=None)
def _slot_exponents(N: int) -> np.ndarray:
    """Root exponent of slot j: e_j = 5^j mod 2N. {+-5^j} covers every odd
    residue mod 2N exactly once, so this is a full conjugate-pair set; in
    this ordering the Galois map X -> X^(5^r) cyclically rotates slots
    (slot j of the image reads slot j+r), which is why the reference packs
    slots the same way (ckksrns-fhe.cpp rotation indexing)."""
    e = np.empty(N // 2, dtype=np.int64)
    cur = 1
    for j in range(N // 2):
        e[j] = cur
        cur = (cur * 5) % (2 * N)
    return e


def _embedding_roots(N: int) -> np.ndarray:
    """One 2N-th primitive root per conjugate pair: zeta^(5^j), j < N/2."""
    return np.exp(1j * np.pi * _slot_exponents(N) / N)


@lru_cache(maxsize=4)
def _embedding_matrix(N: int) -> np.ndarray:
    """[N/2, N] zeta^{-(2j+1)k} — cached: building it costs ~N^2/2 complex
    pows, which dominated encode() when called per transform diagonal
    (N = 4096 -> ~0.5 s/call x thousands of diagonals)."""
    roots = _embedding_roots(N)
    k = np.arange(N)
    return roots[:, None] ** (-k[None, :])


def encode(params: CKKSParams, z, scale: float | None = None) -> np.ndarray:
    """Complex slot vector [<= N/2] -> integer coefficient vector [N]
    (round(Delta * inv-embedding))."""
    N = params.N
    scale = params.scale if scale is None else scale
    zf = np.zeros(N // 2, dtype=np.complex128)
    z = np.asarray(z, dtype=np.complex128).reshape(-1)
    zf[:z.size] = z
    # m_k = (2/N) * Re( sum_j zf_j * conj(roots_j)^k )  (conjugate pair folded)
    M = _embedding_matrix(N)                          # [N/2, N]
    mk = (2.0 / N) * np.real(zf[None, :] @ M).reshape(N)
    return np.round(mk * scale).astype(np.int64)


def decode(params: CKKSParams, coeffs, scale: float) -> np.ndarray:
    """Centered big-int coefficients [N] -> complex slots [N/2]."""
    N = params.N
    V = np.conj(_embedding_matrix(N))                 # [N/2, N] zeta^{+...}
    c = np.array([float(x) for x in coeffs])
    return (V @ c) / scale


class CKKSContext:
    def __init__(self, params: CKKSParams, seed: int | None = None):
        self.params = params
        self.rng = BinFHERng(seed)

    # sampling (same structure as BFV; kept local since params types differ)
    def _uniform(self, dcrt: DCRTParams) -> DCRTPoly:
        rns = np.stack([self.rng.discrete_uniform(dcrt.N, m) for m in dcrt.moduli])
        return DCRTPoly(dcrt, rns.astype(np.uint64), eval_form=False).to_eval()

    def _gaussian(self, dcrt: DCRTParams) -> DCRTPoly:
        e = self.rng.discrete_gaussian_signed(self.params.N, self.params.std)
        return DCRTPoly.from_signed(dcrt, e, eval_form=True)

    def _ternary(self, dcrt: DCRTParams):
        v = self.rng.ternary_uniform_signed(self.params.N)
        return DCRTPoly.from_signed(dcrt, v, eval_form=True), v

    def key_gen(self, secret_dist: str = "uniform",
                hamming_weight: int = 64):
        """Key pair with the chosen SecretKeyDist (base-pke.cpp:60-73):
        'uniform' = uniform ternary, 'sparse' = ternary with the given
        hamming weight (SPARSE_TERNARY, h = 64 there — enables the
        small-K bootstrap configuration), 'gaussian' = discrete Gaussian."""
        d = self.params.dcrt
        if secret_dist == "uniform":
            s, s_signed = self._ternary(d)
        elif secret_dist == "sparse":
            v = self.rng.ternary_uniform_signed(
                self.params.N, hamming_weight=hamming_weight)
            s, s_signed = DCRTPoly.from_signed(d, v, eval_form=True), v
        elif secret_dist == "gaussian":
            v = self.rng.discrete_gaussian_signed(self.params.N,
                                                  self.params.std)
            s, s_signed = DCRTPoly.from_signed(d, v, eval_form=True), v
        else:
            raise ValueError(f"unknown secret_dist {secret_dist!r}")
        a = self._uniform(d)
        e = self._gaussian(d)
        return (s, s_signed), (-(a * s + e), a)

    def relin_key_gen(self, sk) -> tuple[list, list]:
        s, _ = sk
        d = self.params.dcrt
        T = 1 << self.params.relin_window
        n_digits = (self.params.Q.bit_length() + self.params.relin_window - 1) \
            // self.params.relin_window
        s2 = s * s
        bs, as_ = [], []
        for dd in range(n_digits):
            a_d = self._uniform(d)
            e_d = self._gaussian(d)
            bs.append(-(a_d * s + e_d) + s2.mul_scalar(pow(T, dd, self.params.Q)))
            as_.append(a_d)
        return bs, as_

    def encrypt(self, pk, z, scale: float | None = None) -> CKKSCiphertext:
        p = self.params
        scale = p.scale if scale is None else scale
        m = encode(p, z, scale)
        dm = DCRTPoly.from_signed(p.dcrt, m, eval_form=True)
        u, _ = self._ternary(p.dcrt)
        e1, e2 = self._gaussian(p.dcrt), self._gaussian(p.dcrt)
        b, a = pk
        return CKKSCiphertext([b * u + e1 + dm, a * u + e2], scale, p)

    def _sk_at(self, sk, dcrt: DCRTParams) -> DCRTPoly:
        _, s_signed = sk
        return DCRTPoly.from_signed(dcrt, s_signed, eval_form=True)

    def decrypt(self, sk, ct: CKKSCiphertext) -> np.ndarray:
        lp = ct.level_params
        s = self._sk_at(sk, lp)
        acc = ct.polys[0]
        s_pow = s
        for c in ct.polys[1:]:
            acc = acc + c * s_pow
            s_pow = s_pow * s
        return decode(ct.params, acc.to_centered_bigint(), ct.scale)

    def eval_add(self, a: CKKSCiphertext, b: CKKSCiphertext) -> CKKSCiphertext:
        assert abs(a.scale - b.scale) < 1e-6
        assert a.level_params.moduli == b.level_params.moduli
        return CKKSCiphertext([x + y for x, y in zip(a.polys, b.polys)],
                              a.scale, a.params)

    def eval_mult(self, a: CKKSCiphertext, b: CKKSCiphertext,
                  rlk=None, rescale: bool = True) -> CKKSCiphertext:
        assert len(a.polys) == 2 and len(b.polys) == 2
        lp = a.level_params
        p = self.params
        ca = [x.to_centered_bigint() for x in a.polys]
        cb = [x.to_centered_bigint() for x in b.polys]

        class _B:  # bound context for _negacyclic_bigint
            N = p.N
            Q = lp.Q
        d0 = _negacyclic_bigint(ca[0], cb[0], _B)
        d1a = _negacyclic_bigint(ca[0], cb[1], _B)
        d1b = _negacyclic_bigint(ca[1], cb[0], _B)
        d1 = [x + y for x, y in zip(d1a, d1b)]
        d2 = _negacyclic_bigint(ca[1], cb[1], _B)
        Q = lp.Q
        polys = [DCRTPoly.from_bigint(lp, [c % Q for c in cs]).to_eval()
                 for cs in (d0, d1, d2)]
        ct = CKKSCiphertext(polys, a.scale * b.scale, p)
        if rlk is not None:
            ct = self.relinearize(ct, rlk)
        return self.rescale(ct) if rescale else ct

    def relinearize(self, ct: CKKSCiphertext, rlk) -> CKKSCiphertext:
        if len(ct.polys) == 2:
            return ct
        from .keyswitch import HybridKSKey, hybrid_key_switch
        if isinstance(rlk, HybridKSKey):
            lp = ct.level_params
            d0, d1 = hybrid_key_switch(rlk, ct.polys[2], lp)
            return CKKSCiphertext([ct.polys[0] + d0, ct.polys[1] + d1],
                                  ct.scale, ct.params)
        bs, as_ = rlk
        lp = ct.level_params
        p = self.params
        w = p.relin_window
        T = 1 << w
        c2 = ct.polys[2].to_bigint()
        c0, c1 = ct.polys[0], ct.polys[1]
        n_digits = (lp.Q.bit_length() + w - 1) // w
        for d in range(n_digits):
            digit = [(c >> (w * d)) & (T - 1) for c in c2]
            dp = DCRTPoly.from_bigint(lp, digit).to_eval()
            c0 = c0 + _at_level(bs[d], lp) * dp
            c1 = c1 + _at_level(as_[d], lp) * dp
        return CKKSCiphertext([c0, c1], ct.scale, p)

    def rescale(self, ct: CKKSCiphertext) -> CKKSCiphertext:
        """Drop the last RNS limb: c' = round(c / q_last), scale /= q_last."""
        lp = ct.level_params
        assert lp.L > 1, "no limbs left to rescale"
        q_last = lp.moduli[-1]
        new_lp = DCRTParams(N=lp.N, moduli=lp.moduli[:-1])
        out = []
        for poly in ct.polys:
            c = poly.to_centered_bigint()
            scaled = [(2 * x + q_last) // (2 * q_last) for x in c]  # round(x/q)
            out.append(DCRTPoly.from_bigint(new_lp, [x % new_lp.Q for x in scaled]).to_eval())
        return CKKSCiphertext(out, ct.scale / q_last, ct.params)


def _at_level(poly: DCRTPoly, lp: DCRTParams) -> DCRTPoly:
    """Restrict a full-chain tower to a reduced chain (drop trailing limbs)."""
    if poly.params is lp or poly.params.moduli == lp.moduli:
        return DCRTPoly(lp, poly.rns[:lp.L], poly.eval_form)
    assert poly.params.moduli[:lp.L] == lp.moduli
    return DCRTPoly(lp, poly.rns[:lp.L], poly.eval_form)
