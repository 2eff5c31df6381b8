"""Advanced SHE operations on CKKS ciphertexts.

Port of `tfhe_tpu/pke/advancedshe.py`, on the exact host CKKS as there
(`advancedshe_device.py` runs the same family on device towers). Mirrors
the reference's scheme-base advanced layer plus the CKKS-specific
polynomial machinery:

  - EvalAddMany / EvalMultMany binary trees, EvalLinearWSum
    (schemebase/base-advancedshe.cpp)
  - EvalPoly in the power basis: linear for small degree,
    Paterson-Stockmeyer above (EvalPolyLinear / EvalPolyPS,
    base-advancedshe.cpp)
  - EvalChebyshevSeries / EvalChebyshevFunction and the transcendental
    wrappers EvalSin / EvalCos / EvalLogistic / EvalDivide
    (scheme/ckksrns/ckksrns-advancedshe.cpp, ckksrns-utils.cpp; the
    user-facing wrappers live in cryptocontext.cpp)
  - EvalSum / EvalSumRows / EvalSumCols / EvalMerge over packed slots
    (base-advancedshe.cpp rotate-and-add trees)

All of it is built from the leveled CKKS primitives in `ckks.py` /
`ckks_boot.py` (add_ct, mult_ct, mult_const, eval_rotate) so every op is
available on the host-exact tier and — through the same algebra — on the
RNS/device tiers.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from .ckks import CKKSCiphertext, CKKSContext
from .ckks_boot import (add_const, add_ct, eval_chebyshev_ps, eval_rotate,
                        galois_element, galois_key_gen, mult_const, mult_ct,
                        mult_plain_vec, sub_ct)

__all__ = [
    "rotation_key_gen", "eval_add_many", "eval_mult_many",
    "eval_linear_wsum", "eval_poly", "eval_chebyshev_series",
    "eval_chebyshev_function", "eval_sin", "eval_cos", "eval_logistic",
    "eval_divide", "eval_sum", "eval_sum_rows", "eval_sum_cols",
    "eval_merge",
]


def rotation_key_gen(ctx: CKKSContext, sk, rots: Sequence[int]) -> dict:
    """Galois keys for the given slot rotations (EvalAtIndexKeyGen /
    EvalRotateKeyGen, cryptocontext.cpp). Returns {galois_element: key},
    the map `eval_rotate` consumes."""
    keys = {}
    for r in rots:
        k = galois_element(r, ctx.params.N)
        if k not in keys:
            keys[k] = galois_key_gen(ctx, sk, k)
    return keys


# -- many-operand trees ------------------------------------------------------

def eval_add_many(cts: Sequence[CKKSCiphertext]) -> CKKSCiphertext:
    """Binary addition tree (EvalAddMany, base-advancedshe.cpp): log-depth
    in the *scale alignment*, though addition costs no levels."""
    assert cts, "eval_add_many needs at least one ciphertext"
    layer = list(cts)
    while len(layer) > 1:
        nxt = [add_ct(layer[i], layer[i + 1])
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def eval_mult_many(ctx: CKKSContext, cts: Sequence[CKKSCiphertext],
                   rlk) -> CKKSCiphertext:
    """Binary multiplication tree (EvalMultMany, base-advancedshe.cpp):
    ceil(log2(n)) multiplicative levels instead of n-1 for a left fold."""
    assert cts, "eval_mult_many needs at least one ciphertext"
    layer = list(cts)
    while len(layer) > 1:
        nxt = [mult_ct(ctx, layer[i], layer[i + 1], rlk)
               for i in range(0, len(layer) - 1, 2)]
        if len(layer) % 2:
            nxt.append(layer[-1])
        layer = nxt
    return layer[0]


def eval_linear_wsum(ctx: CKKSContext, cts: Sequence[CKKSCiphertext],
                     weights: Sequence[float]) -> CKKSCiphertext:
    """sum_i w_i * ct_i at one multiplicative level (EvalLinearWSum,
    ckksrns-advancedshe.cpp)."""
    assert len(cts) == len(weights) and cts
    acc = None
    for ct, w in zip(cts, weights):
        if abs(w) < 1e-14:
            continue
        term = mult_const(ctx, ct, float(w))
        acc = term if acc is None else add_ct(acc, term)
    assert acc is not None, "all weights were zero"
    return acc


# -- polynomial evaluation (power basis) -------------------------------------

class _PowerPS:
    """Paterson-Stockmeyer evaluation of sum_j c_j x^j (EvalPolyPS,
    base-advancedshe.cpp). Baby powers x^1..x^k, giant powers x^(k*2^i) by
    squaring, then the power-basis split f = q(x)*x^e + r(x) — which in the
    monomial basis is just a coefficient slice."""

    def __init__(self, ctx: CKKSContext, x: CKKSCiphertext, rlk, k: int):
        self.ctx, self.rlk, self.k = ctx, rlk, k
        self.P: dict[int, CKKSCiphertext] = {1: x}

    def power(self, j: int) -> CKKSCiphertext:
        if j not in self.P:
            if j <= self.k:
                hi, lo = (j + 1) // 2, j // 2
                self.P[j] = mult_ct(self.ctx, self.power(hi), self.power(lo),
                                    self.rlk)
            else:
                half = self.power(j // 2)
                self.P[j] = mult_ct(self.ctx, half, half, self.rlk)
        return self.P[j]

    def run(self, coeffs: np.ndarray) -> CKKSCiphertext:
        ct, const = self._eval(np.asarray(coeffs, dtype=np.float64))
        if ct is None:
            raise ValueError("eval_poly of a constant polynomial")
        return add_const(self.ctx, ct, const) if abs(const) > 1e-14 else ct

    def _eval(self, c: np.ndarray):
        n = len(c) - 1
        while n > 0 and abs(c[n]) < 1e-14:
            n -= 1
        c = c[:n + 1]
        if n < self.k:                     # leaf: baby linear combination
            acc = None
            for j in range(1, n + 1):
                if abs(c[j]) < 1e-14:
                    continue
                term = mult_const(self.ctx, self.power(j), float(c[j]))
                acc = term if acc is None else add_ct(acc, term)
            return acc, float(c[0])
        e = self.k
        while 2 * e <= n:
            e *= 2
        q_ct, q_const = self._eval(c[e:])
        r_ct, r_const = self._eval(c[:e])
        xe = self.power(e)
        parts = []
        if q_ct is not None:
            parts.append(mult_ct(self.ctx, q_ct, xe, self.rlk))
        if abs(q_const) > 1e-14:
            parts.append(mult_const(self.ctx, xe, q_const))
        if r_ct is not None:
            parts.append(r_ct)
        acc = parts[0]
        for pt in parts[1:]:
            acc = add_ct(acc, pt)
        return acc, r_const


def eval_poly(ctx: CKKSContext, ct: CKKSCiphertext, coeffs,
              rlk) -> CKKSCiphertext:
    """Evaluate sum_j coeffs[j] * ct^j (EvalPoly, cryptocontext.h).
    Degree < 5 uses the direct linear combination of powers
    (EvalPolyLinear); otherwise Paterson-Stockmeyer (EvalPolyPS)."""
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
    return _PowerPS(ctx, ct, rlk, k).run(c[:deg + 1])


# -- Chebyshev series / function approximation -------------------------------

def _affine_to_unit(ctx: CKKSContext, ct: CKKSCiphertext, a: float,
                    b: float) -> CKKSCiphertext:
    """y = (2x - a - b) / (b - a), mapping [a, b] -> [-1, 1]."""
    y = mult_const(ctx, ct, 2.0 / (b - a))
    return add_const(ctx, y, -(a + b) / (b - a))


def eval_chebyshev_series(ctx: CKKSContext, ct: CKKSCiphertext, coeffs,
                          a: float, b: float, rlk) -> CKKSCiphertext:
    """sum_j c_j T_j(y), y the affine image of ct from [a,b] to [-1,1]
    (EvalChebyshevSeries, ckksrns-advancedshe.cpp; always the PS variant —
    the linear recurrence exists only as a host cross-check here)."""
    y = ct if (a, b) == (-1.0, 1.0) else _affine_to_unit(ctx, ct, a, b)
    return eval_chebyshev_ps(ctx, y, np.asarray(coeffs, np.float64), rlk)


def eval_chebyshev_function(ctx: CKKSContext, f: Callable[[np.ndarray], np.ndarray],
                            ct: CKKSCiphertext, a: float, b: float,
                            degree: int, rlk) -> CKKSCiphertext:
    """Approximate f on [a, b] by a degree-`degree` Chebyshev interpolant and
    evaluate it (EvalChebyshevFunction, ckksrns-utils.cpp EvalChebyshevCoefficients
    + EvalChebyshevSeries)."""
    coeffs = np.polynomial.chebyshev.chebinterpolate(
        lambda t: f((b - a) * t / 2.0 + (a + b) / 2.0), degree)
    return eval_chebyshev_series(ctx, ct, coeffs, a, b, rlk)


def eval_sin(ctx, ct, a, b, degree, rlk):
    """EvalSin (cryptocontext.h)."""
    return eval_chebyshev_function(ctx, np.sin, ct, a, b, degree, rlk)


def eval_cos(ctx, ct, a, b, degree, rlk):
    """EvalCos (cryptocontext.h)."""
    return eval_chebyshev_function(ctx, np.cos, ct, a, b, degree, rlk)


def eval_logistic(ctx, ct, a, b, degree, rlk):
    """EvalLogistic = 1 / (1 + exp(-x)) (cryptocontext.h)."""
    return eval_chebyshev_function(
        ctx, lambda x: 1.0 / (1.0 + np.exp(-x)), ct, a, b, degree, rlk)


def eval_divide(ctx, ct, a, b, degree, rlk):
    """EvalDivide = 1/x on [a, b] not containing 0 (cryptocontext.h)."""
    assert a * b > 0, "EvalDivide needs an interval excluding 0"
    return eval_chebyshev_function(
        ctx, lambda x: 1.0 / x, ct, a, b, degree, rlk)


# -- rotation-tree reductions over packed slots ------------------------------

def sum_key_gen(ctx: CKKSContext, sk, row_size: int | None = None) -> dict:
    """Keys for the rotate-and-add trees below (EvalSumKeyGen /
    EvalSumRowsKeyGen / EvalSumColsKeyGen): all power-of-two rotations up
    to `slots` (both signs, so sum/rows/cols/merge all find their keys)."""
    s = ctx.params.slots
    rots = []
    j = 1
    while j < s:
        rots += [j, -j]
        j *= 2
    rots.append(-1)
    return rotation_key_gen(ctx, sk, rots)


def eval_sum(ctx: CKKSContext, ct: CKKSCiphertext, keys: dict,
             batch_size: int | None = None) -> CKKSCiphertext:
    """Every slot becomes the sum of the first `batch_size` slots
    (EvalSum over a power-of-two batch, base-advancedshe.cpp): log2(bs)
    rotate-and-adds, no multiplicative depth."""
    s = ctx.params.slots
    bs = batch_size or s
    assert bs & (bs - 1) == 0 and bs <= s, "batch_size must be a power of two"
    j = 1
    while j < bs:
        ct = add_ct(ct, eval_rotate(ctx, ct, j, keys))
        j *= 2
    return ct


def eval_sum_rows(ctx: CKKSContext, ct: CKKSCiphertext, row_size: int,
                  keys: dict) -> CKKSCiphertext:
    """Column sums of a row-major [slots/row_size, row_size] packed matrix:
    every row of the result equals the sum of the input rows (EvalSumRows,
    base-advancedshe.cpp — rotations by row_size * 2^j)."""
    s = ctx.params.slots
    assert row_size & (row_size - 1) == 0 and s % row_size == 0
    j = row_size
    while j < s:
        ct = add_ct(ct, eval_rotate(ctx, ct, j, keys))
        j *= 2
    return ct


def eval_sum_cols(ctx: CKKSContext, ct: CKKSCiphertext, row_size: int,
                  keys: dict) -> CKKSCiphertext:
    """Row sums of a row-major packed matrix: every slot of row r becomes
    the sum of row r (EvalSumCols, base-advancedshe.cpp). log2(R) cyclic
    rotate-and-adds put the row sum at each row's first column (rotation is
    cyclic over the full slot vector and row_size | slots, so each row-start
    slot mixes only its own row); a mask isolates those, then a reverse
    doubling tree replicates across the row. Costs one multiplicative level
    (the mask)."""
    s = ctx.params.slots
    R = row_size
    assert R & (R - 1) == 0 and s % R == 0
    j = 1
    while j < R:
        ct = add_ct(ct, eval_rotate(ctx, ct, j, keys))
        j *= 2
    mask = np.zeros(s)
    mask[::R] = 1.0
    ct = mult_plain_vec(ctx, ct, mask)
    j = 1
    while j < R:
        ct = add_ct(ct, eval_rotate(ctx, ct, -j, keys))
        j *= 2
    return ct


def eval_merge(ctx: CKKSContext, cts: Sequence[CKKSCiphertext],
               keys: dict) -> CKKSCiphertext:
    """Pack slot 0 of each input into consecutive slots of one ciphertext
    (EvalMerge, base-advancedshe.cpp): mask slot 0, then fold with a single
    rotate(-1) key — acc starts at the last input and each step shifts the
    packed prefix up one slot."""
    assert cts and len(cts) <= ctx.params.slots
    mask = np.zeros(ctx.params.slots)
    mask[0] = 1.0
    acc = mult_plain_vec(ctx, cts[-1], mask)
    for ct in reversed(cts[:-1]):
        acc = eval_rotate(ctx, acc, -1, keys)
        acc = add_ct(acc, mult_plain_vec(ctx, ct, mask))
    return acc
