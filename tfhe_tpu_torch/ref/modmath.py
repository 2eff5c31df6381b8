"""Exact modular arithmetic over numpy arrays, for the host oracle backend.

Two engines, selected by modulus size:
- moduli < 2^31: plain uint64 arithmetic (products < 2^62 are exact),
- moduli in [2^31, 2^62) (odd): Montgomery multiplication on uint64 with the
  128-bit product assembled from 32-bit halves — no Python-int fallback, so the
  54-bit ring primes of the accelerated parameter sets stay fast on the host.

This is the bit-exactness oracle standing in for the reference's NativeInteger
/ NativeVector layer (`src/core/include/math/hal/intnat/ubintnat.h`,
`mubintvecnat.h`); the reference similarly switches between 64-bit Barrett and
128-bit intermediate products.
"""

from __future__ import annotations

import functools

import numpy as np

_SMALL_LIMIT = 1 << 31
_U64 = np.uint64
_MASK32 = _U64(0xFFFFFFFF)
_S32 = _U64(32)


def _mul_full_u64(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact 64x64 -> 128-bit product as (hi, lo) uint64 pairs."""
    a_lo = a & _MASK32
    a_hi = a >> _S32
    b_lo = b & _MASK32
    b_hi = b >> _S32
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = lh + (ll >> _S32)          # < 2^33 * 2^32, no overflow
    mid_lo = mid & _MASK32
    mid_hi = mid >> _S32
    mid2 = hl + mid_lo               # < 2^64
    lo = (ll & _MASK32) | ((mid2 & _MASK32) << _S32)
    hi = hh + mid_hi + (mid2 >> _S32)
    return hi, lo


@functools.lru_cache(maxsize=None)
class MontgomeryEngine:
    """Montgomery arithmetic mod an odd modulus Q < 2^62, R = 2^64."""

    def __init__(self, Q: int):
        assert Q % 2 == 1 and Q < (1 << 62)
        self.Q = Q
        self.Qv = _U64(Q)
        self.neg_q_inv = _U64((-pow(Q, -1, 1 << 64)) % (1 << 64))
        self.r2 = _U64((1 << 128) % Q)

    def _redc(self, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
        """(hi*2^64 + lo) * 2^-64 mod Q, assuming hi*2^64 + lo < Q * 2^64."""
        m = lo * self.neg_q_inv                       # wrapping mod 2^64
        mq_hi, _ = _mul_full_u64(m, np.broadcast_to(self.Qv, m.shape).astype(_U64))
        carry = (lo != _U64(0)).astype(_U64)
        t = hi + mq_hi + carry
        return np.where(t >= self.Qv, t - self.Qv, t)

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Exact (a * b) mod Q for a, b in [0, Q)."""
        hi, lo = _mul_full_u64(np.asarray(a, dtype=_U64), np.asarray(b, dtype=_U64))
        t = self._redc(hi, lo)                        # a*b*2^-64
        hi2, lo2 = _mul_full_u64(t, np.broadcast_to(self.r2, t.shape).astype(_U64))
        return self._redc(hi2, lo2)                   # a*b


def zeros(n, modulus: int) -> np.ndarray:
    return np.zeros(n, dtype=np.uint64)


def asarray(values, modulus: int) -> np.ndarray:
    """Residues in [0, modulus) from arbitrary (possibly signed) ints."""
    a = np.asarray(values)
    if a.dtype == object:
        return np.array([int(v) % modulus for v in a.ravel()],
                        dtype=np.uint64).reshape(a.shape)
    return (a.astype(np.int64) % np.int64(modulus)).astype(np.uint64)


def add(a, b, modulus: int):
    return (np.asarray(a, dtype=_U64) + np.asarray(b, dtype=_U64)) % _U64(modulus)


def sub(a, b, modulus: int):
    m = _U64(modulus)
    return (np.asarray(a, dtype=_U64) + m - np.asarray(b, dtype=_U64)) % m


@functools.lru_cache(maxsize=None)
def _crt_split(modulus: int) -> tuple[int, int, int] | None:
    """Factor a composite modulus into two coprime halves < 2^32 (the
    accelerated sets' Q = q1*q2 of two ~27-bit NTT primes). Returns
    (q1, q2, garner) or None when no such split exists."""
    if modulus < _SMALL_LIMIT or modulus >= (1 << 62):
        return None
    # trial division by odd candidates below 2^32 is hopeless in general, but
    # the moduli we meet are products of two primes of similar size:
    # Pollard-rho from the number-theory kit finds them instantly
    from ..utils.numtheory import _factorize, is_prime

    if is_prime(modulus):
        return None
    try:
        primes = _factorize(modulus)
    except Exception:
        return None
    if len(primes) != 2:
        return None
    q1, q2 = max(primes), min(primes)
    if q1 * q2 != modulus or q1 >= (1 << 32):
        return None
    return q1, q2, pow(q2, -1, q1)


def _crt_mul(a, b, q1: int, q2: int, garner: int):
    """(a*b) mod q1*q2 via per-prime u64 lanes (exact: qi < 2^32) + Garner
    recombination — ~4x fewer element passes than 64-bit Montgomery, which
    matters at bootstrapping-key scale (~10^8 products) on a 1-core host."""
    u1, u2, g = _U64(q1), _U64(q2), _U64(garner)
    a = np.asarray(a, dtype=_U64)
    b = np.asarray(b, dtype=_U64)
    r1 = ((a % u1) * (b % u1)) % u1
    r2 = ((a % u2) * (b % u2)) % u2
    t = (((r1 + u1 - r2 % u1) % u1) * g) % u1    # (r1-r2)*q2^-1 mod q1
    return t * u2 + r2


def mul(a, b, modulus: int):
    """Exact modular product for any modulus < 2^62."""
    if modulus < _SMALL_LIMIT:
        return (np.asarray(a, dtype=_U64) * np.asarray(b, dtype=_U64)) % _U64(modulus)
    big = np.asarray(a).size >= (1 << 16)
    split = _crt_split(modulus) if big else None
    if split is not None:
        return _crt_mul(a, b, *split)
    return MontgomeryEngine(modulus).mul(a, b)


def neg(a, modulus: int):
    m = _U64(modulus)
    return (m - np.asarray(a, dtype=_U64)) % m


def switch_modulus(values: np.ndarray, old_mod: int, new_mod: int) -> np.ndarray:
    """NativeVector::SwitchModulus: centered re-embedding — values > oldQ/2 map to
    value - oldQ + newQ (mubintvecnat.cpp:200-221; note strict >)."""
    signed = to_signed(values, old_mod, half_negative=False)
    return from_signed(signed, new_mod)


def to_signed(values: np.ndarray, modulus: int, half_negative: bool = True) -> np.ndarray:
    """Residues -> centered representatives (int64; modulus < 2^62).

    half_negative=True follows the decompose convention `t < Q/2 ? t : t - Q`
    (rgsw-acc.cpp:83); False follows SwitchModulus's strict `t > Q/2`
    (mubintvecnat.cpp:208). They differ only at t == Q/2 (even moduli only).
    """
    half = modulus >> 1
    v = np.asarray(values, dtype=_U64)
    pos = v < _U64(half) if half_negative else v <= _U64(half)
    return np.where(pos, v.astype(np.int64), v.astype(np.int64) - np.int64(modulus))


def from_signed(signed, modulus: int) -> np.ndarray:
    return (np.asarray(signed, dtype=np.int64) % np.int64(modulus)).astype(np.uint64)


def round_q_Q(v, q: int, Q: int):
    """RoundqQ: round(v * q / Q) mod q with exact rational round-half-up
    (lwe-pke.cpp:41-46 computes floor(0.5 + v*q/Q) in float64; the exact value
    floor((2vq + Q) / (2Q)) coincides except on float64 ulp pathologies with
    probability ~2^-41 per coefficient — see docs/PARITY.md)."""
    scalar = not isinstance(v, np.ndarray)
    varr = np.asarray(v, dtype=_U64)
    if Q.bit_length() + q.bit_length() <= 62:
        num = _U64(2) * varr * _U64(q) + _U64(Q)
        out = (num // _U64(2 * Q)) % _U64(q)
    else:
        # v*q can exceed 2^63: do the scaled division in 128-bit pieces.
        # floor((2vq + Q) / 2Q) with v < Q < 2^62, q < 2^36.
        flat = varr.ravel()
        res = np.empty(flat.shape, dtype=_U64)
        qq = 2 * Q
        for i, x in enumerate(flat.tolist()):
            res[i] = ((2 * x * q + Q) // qq) % q
        out = res.reshape(varr.shape)
    if scalar:
        return int(out)
    return out
