"""Advanced SHE operations on DEVICE-resident CKKS ciphertexts.

Port of `tfhe_tpu/pke/advancedshe_device.py`, the device run of
pke/advancedshe.py: the function family the reference exposes through
CryptoContext (EvalAddMany / EvalMultMany / EvalLinearWSum, EvalPoly with
the Paterson-Stockmeyer split, the EvalChebyshev* series and
transcendental wrappers, and the EvalSum / EvalSumRows / EvalSumCols /
EvalMerge rotation trees: schemebase/base-advancedshe.cpp,
scheme/ckksrns/ckksrns-advancedshe.cpp, cryptocontext.cpp), with every
homomorphic op running through the device tower functions via
`CKKSDeviceEvaluator` (ckks_boot_device.py): add/sub/mult/relin/rescale,
plaintext mults with the NTT on the device, and level-aware packed hybrid
Galois keys. Towers are bit-identical to the JAX package's on the same
keys and inputs.

Everything takes the evaluator `ev` first: it owns the device context,
the packed key map and the plaintext caches, as CryptoContext owns the
EvalSum/rotation key maps in the reference.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .ckks_boot_device import CKKSDeviceEvaluator
from .ckks_device import DeviceCKKSCiphertext

__all__ = [
    "sum_key_gen", "eval_add_many", "eval_mult_many", "eval_linear_wsum",
    "eval_poly", "eval_chebyshev_series", "eval_chebyshev_function",
    "eval_sin", "eval_cos", "eval_logistic", "eval_divide",
    "eval_sum", "eval_sum_rows", "eval_sum_cols", "eval_merge",
]


def sum_key_gen(ev: CKKSDeviceEvaluator, sk) -> None:
    """Relin key + Galois keys for the rotate-and-add trees below
    (EvalSumKeyGen / EvalSumRowsKeyGen / EvalSumColsKeyGen): all
    power-of-two rotations up to `slots`, both signs, plus rotate(-1)
    for EvalMerge."""
    s = ev.params.slots
    rots = []
    j = 1
    while j < s:
        rots += [j, -j]
        j *= 2
    rots.append(-1)
    ev.keygen_rotations(sk, rots)


# -- many-operand trees ------------------------------------------------------

def eval_add_many(ev: CKKSDeviceEvaluator,
                  cts: Sequence[DeviceCKKSCiphertext]) -> DeviceCKKSCiphertext:
    """Binary addition tree (EvalAddMany, base-advancedshe.cpp)."""
    assert cts, "eval_add_many needs at least one ciphertext"
    layer = list(cts)
    while len(layer) > 1:
        nxt = [ev.add(layer[i], layer[i + 1])
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def eval_mult_many(ev: CKKSDeviceEvaluator,
                   cts: Sequence[DeviceCKKSCiphertext]) -> DeviceCKKSCiphertext:
    """Binary multiplication tree (EvalMultMany, base-advancedshe.cpp):
    ceil(log2(n)) multiplicative levels instead of n-1 for a left fold."""
    assert cts, "eval_mult_many needs at least one ciphertext"
    layer = list(cts)
    while len(layer) > 1:
        nxt = [ev.mult(layer[i], layer[i + 1])
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def eval_linear_wsum(ev: CKKSDeviceEvaluator,
                     cts: Sequence[DeviceCKKSCiphertext],
                     weights: Sequence[float]) -> DeviceCKKSCiphertext:
    """sum_i w_i * ct_i at one multiplicative level (EvalLinearWSum,
    ckksrns-advancedshe.cpp)."""
    assert len(cts) == len(weights) and cts
    acc = None
    for ct, w in zip(cts, weights):
        if abs(w) < 1e-14:
            continue
        term = ev.mult_const(ct, float(w))
        acc = term if acc is None else ev.add(acc, term)
    assert acc is not None, "all weights were zero"
    return acc


# -- polynomial evaluation (power basis) -------------------------------------

class _PowerPS:
    """Paterson-Stockmeyer evaluation of sum_j c_j x^j on the device tier
    (EvalPolyPS, base-advancedshe.cpp): baby powers x^1..x^k, giant powers
    x^(k*2^i) by squaring, then the monomial-basis split f = q*x^e + r
    (a coefficient slice)."""

    def __init__(self, ev: CKKSDeviceEvaluator, x: DeviceCKKSCiphertext,
                 k: int):
        self.ev, self.k = ev, k
        self.P: dict[int, DeviceCKKSCiphertext] = {1: x}

    def power(self, j: int) -> DeviceCKKSCiphertext:
        if j not in self.P:
            if j <= self.k:
                hi, lo = (j + 1) // 2, j // 2
                self.P[j] = self.ev.mult(self.power(hi), self.power(lo))
            else:
                half = self.power(j // 2)
                self.P[j] = self.ev.mult(half, half)
        return self.P[j]

    def run(self, coeffs: np.ndarray) -> DeviceCKKSCiphertext:
        ct, const = self._eval(np.asarray(coeffs, dtype=np.float64))
        if ct is None:
            raise ValueError("eval_poly of a constant polynomial")
        return self.ev.add_const(ct, const) if abs(const) > 1e-14 else ct

    def _eval(self, c: np.ndarray):
        ev = self.ev
        n = len(c) - 1
        while n > 0 and abs(c[n]) < 1e-14:
            n -= 1
        c = c[:n + 1]
        if n < self.k:                     # leaf: baby linear combination
            acc = None
            for j in range(1, n + 1):
                if abs(c[j]) < 1e-14:
                    continue
                term = ev.mult_const(self.power(j), float(c[j]))
                acc = term if acc is None else ev.add(acc, term)
            return acc, float(c[0])
        e = self.k
        while 2 * e <= n:
            e *= 2
        q_ct, q_const = self._eval(c[e:])
        r_ct, r_const = self._eval(c[:e])
        xe = self.power(e)
        parts = []
        if q_ct is not None:
            parts.append(ev.mult(q_ct, xe))
        if abs(q_const) > 1e-14:
            parts.append(ev.mult_const(xe, q_const))
        if r_ct is not None:
            parts.append(r_ct)
        acc = parts[0]
        for pt in parts[1:]:
            acc = ev.add(acc, pt)
        return acc, r_const


def eval_poly(ev: CKKSDeviceEvaluator, ct: DeviceCKKSCiphertext,
              coeffs) -> DeviceCKKSCiphertext:
    """Evaluate sum_j coeffs[j] * ct^j on device (EvalPoly,
    cryptocontext.h). Degree < 5 uses the direct linear combination of
    powers (EvalPolyLinear); otherwise Paterson-Stockmeyer (EvalPolyPS)."""
    c = np.asarray(coeffs, dtype=np.float64)
    deg = len(c) - 1
    while deg > 0 and abs(c[deg]) < 1e-14:
        deg -= 1
    if deg == 0:
        raise ValueError("eval_poly of a constant polynomial")
    if deg < 5:
        k = deg  # all powers are 'baby' powers -> plain linear combination
    else:
        k = max(2, 1 << int(np.ceil(np.log2(max(2.0, np.sqrt(deg / 2))))))
    return _PowerPS(ev, ct, k).run(c[:deg + 1])


# -- Chebyshev series / function approximation -------------------------------

def eval_chebyshev_series(ev: CKKSDeviceEvaluator, ct: DeviceCKKSCiphertext,
                          coeffs, a: float, b: float) -> DeviceCKKSCiphertext:
    """sum_j c_j T_j(y), y the affine image of ct from [a,b] to [-1,1]
    (EvalChebyshevSeries, ckksrns-advancedshe.cpp — the PS variant, via
    the evaluator's chebyshev_ps)."""
    y = ct
    if (a, b) != (-1.0, 1.0):
        y = ev.add_const(ev.mult_const(ct, 2.0 / (b - a)),
                         -(a + b) / (b - a))
    return ev.chebyshev_ps(y, np.asarray(coeffs, np.float64))


def eval_chebyshev_function(ev: CKKSDeviceEvaluator,
                            f: Callable[[np.ndarray], np.ndarray],
                            ct: DeviceCKKSCiphertext, a: float, b: float,
                            degree: int) -> DeviceCKKSCiphertext:
    """Approximate f on [a, b] by a degree-`degree` Chebyshev interpolant
    and evaluate it on device (EvalChebyshevFunction, ckksrns-utils.cpp)."""
    coeffs = np.polynomial.chebyshev.chebinterpolate(
        lambda t: f((b - a) * t / 2.0 + (a + b) / 2.0), degree)
    return eval_chebyshev_series(ev, ct, coeffs, a, b)


def eval_sin(ev, ct, a, b, degree):
    """EvalSin (cryptocontext.h)."""
    return eval_chebyshev_function(ev, np.sin, ct, a, b, degree)


def eval_cos(ev, ct, a, b, degree):
    """EvalCos (cryptocontext.h)."""
    return eval_chebyshev_function(ev, np.cos, ct, a, b, degree)


def eval_logistic(ev, ct, a, b, degree):
    """EvalLogistic = 1 / (1 + exp(-x)) (cryptocontext.h)."""
    return eval_chebyshev_function(
        ev, lambda x: 1.0 / (1.0 + np.exp(-x)), ct, a, b, degree)


def eval_divide(ev, ct, a, b, degree):
    """EvalDivide = 1/x on [a, b] not containing 0 (cryptocontext.h)."""
    assert a * b > 0, "EvalDivide needs an interval excluding 0"
    return eval_chebyshev_function(ev, lambda x: 1.0 / x, ct, a, b, degree)


# -- rotation-tree reductions over packed slots ------------------------------

def eval_sum(ev: CKKSDeviceEvaluator, ct: DeviceCKKSCiphertext,
             batch_size: int | None = None) -> DeviceCKKSCiphertext:
    """Every slot becomes the sum of the first `batch_size` slots (EvalSum,
    base-advancedshe.cpp): log2(bs) rotate-and-adds, no multiplicative
    depth."""
    s = ev.params.slots
    bs = batch_size or s
    assert bs & (bs - 1) == 0 and bs <= s, "batch_size must be a power of two"
    j = 1
    while j < bs:
        ct = ev.add(ct, ev.rotate(ct, j))
        j *= 2
    return ct


def eval_sum_rows(ev: CKKSDeviceEvaluator, ct: DeviceCKKSCiphertext,
                  row_size: int) -> DeviceCKKSCiphertext:
    """Column sums of a row-major [slots/row_size, row_size] packed matrix
    (EvalSumRows, base-advancedshe.cpp — rotations by row_size * 2^j)."""
    s = ev.params.slots
    assert row_size & (row_size - 1) == 0 and s % row_size == 0
    j = row_size
    while j < s:
        ct = ev.add(ct, ev.rotate(ct, j))
        j *= 2
    return ct


def eval_sum_cols(ev: CKKSDeviceEvaluator, ct: DeviceCKKSCiphertext,
                  row_size: int) -> DeviceCKKSCiphertext:
    """Row sums of a row-major packed matrix, replicated across each row
    (EvalSumCols, base-advancedshe.cpp): log2(R) rotate-and-adds, a mask
    isolating the row-start slots (one multiplicative level), then a
    reverse doubling tree."""
    s = ev.params.slots
    R = row_size
    assert R & (R - 1) == 0 and s % R == 0
    j = 1
    while j < R:
        ct = ev.add(ct, ev.rotate(ct, j))
        j *= 2
    mask = np.zeros(s)
    mask[::R] = 1.0
    ct = ev.mult_plain(ct, mask, pt_key=("sumcols_mask", R))
    j = 1
    while j < R:
        ct = ev.add(ct, ev.rotate(ct, -j))
        j *= 2
    return ct


def eval_merge(ev: CKKSDeviceEvaluator,
               cts: Sequence[DeviceCKKSCiphertext]) -> DeviceCKKSCiphertext:
    """Pack slot 0 of each input into consecutive slots of one ciphertext
    (EvalMerge, base-advancedshe.cpp): mask slot 0, then fold with the
    single rotate(-1) key."""
    assert cts and len(cts) <= ev.params.slots
    mask = np.zeros(ev.params.slots)
    mask[0] = 1.0
    acc = ev.mult_plain(cts[-1], mask, pt_key="merge_mask")
    for ct in reversed(cts[:-1]):
        acc = ev.rotate(acc, -1)
        acc = ev.add(acc, ev.mult_plain(ct, mask, pt_key="merge_mask"))
    return acc
