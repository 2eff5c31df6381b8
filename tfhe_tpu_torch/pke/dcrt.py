"""RNS / double-CRT polynomials over Z_Q[X]/(X^N + 1), Q = prod of NTT primes.

Port of `tfhe_tpu/pke/dcrt.py`, the counterpart of the reference's
`DCRTPoly` (`src/core/lib/lattice/hal/default/dcrtpoly.cpp`): a polynomial
is carried as a tower of per-prime residue polynomials [L, N] uint64, each
limb transformed independently by the negacyclic NTT (the port's
`ref/ntt.py`, native-C++ accelerated). Exact big-integer CRT interpolation
is provided for decrypt-time rounding.

Host numpy, as in the JAX package. Towers with limbs below 2^31 go to the
device through `pke/dcrt_device.py` and `pke/ckks_device.py`.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..ref import ntt as ref_ntt
from ..ref import modmath
from ..utils.numtheory import ntt_prime


@lru_cache(maxsize=None)
def _moduli_chain(N: int, n_limbs: int, bits: int, skip: int = 0,
                  extra_mod: int = 1) -> tuple[int, ...]:
    """`n_limbs` distinct NTT primes of ~`bits` bits for ring dim N (all
    congruent to 1 mod lcm(2N, extra_mod)), largest first; `skip` skips the
    first few (for auxiliary bases disjoint from the main chain). BGV passes
    extra_mod = t so modulus switching preserves the message mod t
    (bgvrns-parametergeneration.cpp does the same)."""
    import math

    m = 2 * N * extra_mod // math.gcd(2 * N, extra_mod)
    out: list[int] = []
    p = None
    total = n_limbs + skip
    while len(out) < total:
        p = ntt_prime(bits, m) if p is None else _prev_prime(p, m)
        out.append(p)
    return tuple(out[skip:])


def _prev_prime(p: int, m: int) -> int:
    """Largest NTT prime < p congruent to 1 mod m (mirrors PreviousPrime,
    nbtheory.h)."""
    from ..utils.numtheory import previous_prime
    return previous_prime(p, m)


@lru_cache(maxsize=None)
def _moduli_chain_pattern(N: int, bits_pattern: tuple[int, ...],
                          extra_mod: int = 1) -> tuple[int, ...]:
    """Distinct NTT primes with per-limb target bit sizes, in chain order
    (first limb first). The CKKS production chains use a wide first modulus
    followed by scale-sized limbs (ckksrns-parametergeneration.cpp picks its
    chain the same way: firstModSize then scalingModSize each level)."""
    import math

    m = 2 * N * extra_mod // math.gcd(2 * N, extra_mod)
    chosen: list[int] = []
    cursor: dict[int, int] = {}       # target bits -> last prime taken
    for bits in bits_pattern:
        p = cursor.get(bits)
        p = ntt_prime(bits, m) if p is None else _prev_prime(p, m)
        while p in chosen:            # cross-size collision (adjacent sizes)
            p = _prev_prime(p, m)
        cursor[bits] = p
        chosen.append(p)
    return tuple(chosen)


@dataclass(frozen=True)
class DCRTParams:
    N: int
    moduli: tuple[int, ...]

    @property
    def L(self) -> int:
        return len(self.moduli)

    @property
    def Q(self) -> int:
        q = 1
        for m in self.moduli:
            q *= m
        return q

    @classmethod
    def create(cls, N: int, n_limbs: int, bits: int = 54,
               extra_mod: int = 1) -> "DCRTParams":
        return cls(N=N, moduli=_moduli_chain(N, n_limbs, bits,
                                             extra_mod=extra_mod))


class DCRTPoly:
    """Residue tower [L, N] uint64 with a format flag (COEFF / EVAL)."""

    __slots__ = ("params", "rns", "eval_form")

    def __init__(self, params: DCRTParams, rns: np.ndarray, eval_form: bool):
        self.params = params
        self.rns = rns
        self.eval_form = eval_form

    # -- constructors --------------------------------------------------------

    @classmethod
    def zero(cls, params: DCRTParams, eval_form: bool = True) -> "DCRTPoly":
        return cls(params, np.zeros((params.L, params.N), dtype=np.uint64), eval_form)

    @classmethod
    def from_signed(cls, params: DCRTParams, coeffs: np.ndarray,
                    eval_form: bool = False) -> "DCRTPoly":
        """Signed integer coefficients [N] -> residue tower (coefficient form
        unless requested otherwise)."""
        c = np.asarray(coeffs, dtype=np.int64)
        rns = np.stack([(c % np.int64(m)).astype(np.uint64) for m in params.moduli])
        out = cls(params, rns, eval_form=False)
        return out.to_eval() if eval_form else out

    @classmethod
    def from_bigint(cls, params: DCRTParams, coeffs) -> "DCRTPoly":
        """Arbitrary-precision coefficient array (python ints) -> tower."""
        rns = np.zeros((params.L, params.N), dtype=np.uint64)
        for i, m in enumerate(params.moduli):
            rns[i] = np.array([int(c) % m for c in coeffs], dtype=np.uint64)
        return cls(params, rns, eval_form=False)

    def copy(self) -> "DCRTPoly":
        return DCRTPoly(self.params, self.rns.copy(), self.eval_form)

    # -- format --------------------------------------------------------------

    def to_eval(self) -> "DCRTPoly":
        if self.eval_form:
            return self
        rns = np.stack([ref_ntt.forward(self.rns[i], m)
                        for i, m in enumerate(self.params.moduli)])
        return DCRTPoly(self.params, rns, True)

    def to_coeff(self) -> "DCRTPoly":
        if not self.eval_form:
            return self
        rns = np.stack([ref_ntt.inverse(self.rns[i], m)
                        for i, m in enumerate(self.params.moduli)])
        return DCRTPoly(self.params, rns, False)

    # -- arithmetic ------------------------------------------------------------

    def _binop(self, other: "DCRTPoly", fn) -> "DCRTPoly":
        assert self.eval_form == other.eval_form
        rns = np.stack([fn(self.rns[i], other.rns[i], m)
                        for i, m in enumerate(self.params.moduli)])
        return DCRTPoly(self.params, rns, self.eval_form)

    def __add__(self, other: "DCRTPoly") -> "DCRTPoly":
        return self._binop(other, lambda a, b, m: (a + b) % np.uint64(m))

    def __sub__(self, other: "DCRTPoly") -> "DCRTPoly":
        return self._binop(other, lambda a, b, m: (a + np.uint64(m) - b) % np.uint64(m))

    def __mul__(self, other: "DCRTPoly") -> "DCRTPoly":
        assert self.eval_form and other.eval_form, "ring product needs EVAL form"
        return self._binop(other, lambda a, b, m: modmath.mul(a, b, m))

    def __neg__(self) -> "DCRTPoly":
        rns = np.stack([np.where(self.rns[i] == 0, self.rns[i],
                                 np.uint64(m) - self.rns[i])
                        for i, m in enumerate(self.params.moduli)])
        return DCRTPoly(self.params, rns, self.eval_form)

    def mul_scalar(self, k: int) -> "DCRTPoly":
        rns = np.stack([modmath.mul(self.rns[i],
                                    np.uint64(k % m), m)
                        for i, m in enumerate(self.params.moduli)])
        return DCRTPoly(self.params, rns, self.eval_form)

    # -- CRT interpolation ------------------------------------------------------

    def to_bigint(self) -> list:
        """Exact coefficients in [0, Q) as python ints (coefficient form)."""
        p = self.to_coeff()
        Q = self.params.Q
        acc = [0] * self.params.N
        for i, m in enumerate(self.params.moduli):
            Qi = Q // m
            gi = pow(Qi % m, -1, m)
            row = p.rns[i]
            fac = (Qi * gi) % Q
            for j in range(self.params.N):
                acc[j] = (acc[j] + int(row[j]) * fac) % Q
        return acc

    def to_centered_bigint(self) -> list:
        Q = self.params.Q
        return [c - Q if c > Q // 2 else c for c in self.to_bigint()]
