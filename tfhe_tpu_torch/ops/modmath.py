"""Modular arithmetic on int64 torch tensors.

Port of `tfhe_tpu/ops/modmath32.py`, and of the two-limb functions that the
RNS path needs from `tfhe_tpu/ops/modmath64.py` and `tfhe_tpu/ops/backend.py`
(`round_q_Q64`, `_crt_combine_pair`). The JAX modules build everything from
exact uint32 primitives because 64-bit multiplies are untrustworthy on the
TPU; torch's uint32 has no add, sub, shift or compare on the CPU, so these
plain versions compute in int64 (products of two values < 2^28 stay below
2^56) and callers convert to int32 bit patterns only at a kernel boundary.
"""

from __future__ import annotations

import torch


def addmod(a, b, Q: int):
    return (a + b) % Q


def submod(a, b, Q: int):
    return (a - b) % Q


def negmod(a, Q: int):
    return (-a) % Q


def mod(x, Q: int):
    """x mod Q in [0, Q) for any int64 x; a mask when Q is a power of two."""
    if Q & (Q - 1) == 0:
        return x & (Q - 1)
    return x % Q


def shoup(b, Q: int):
    """Shoup companion floor(b * 2^32 / Q) of residues b < Q < 2^31."""
    return (b << 32) // Q


def round_q_Q(v, q: int, Q: int):
    """RoundqQ (lwe-pke.cpp:41-46) as the exact rational round-half-up
    floor((2vq + Q) / (2Q)) mod q, for residues v < Q.

    While 2(Q - 1)q + Q < 2^63 (every modulus below 2^31) this is one int64
    division. Above that (Q = q1*q2 ~ 2^54 to qKS = 2^35, as
    `modmath64.round_q_Q64` does with 16-bit limbs) the quotient is first
    estimated in float64, where for Q < 2^56 and q <= 2^40 it is off by at
    most one, and then corrected by one exact remainder
    2vq + Q - 2Q*e: that value lies in (-4Q, 4Q), so int64 arithmetic that
    wraps modulo 2^64 gives it exactly even though 2vq itself does not fit."""
    if q == Q:
        return v
    if 2 * (Q - 1) * q + Q < (1 << 63):
        return (2 * v * q + Q) // (2 * Q) % q
    if Q >= (1 << 56) or q > (1 << 40):
        raise ValueError(f"round_q_Q needs Q < 2^56 and q <= 2^40, got {Q}, {q}")
    e = torch.floor(v.to(torch.float64) * (q / Q) + 0.5).to(torch.int64)
    rem = 2 * v * q + Q - 2 * Q * e
    e = e - (rem < 0).to(torch.int64) + (rem >= 2 * Q).to(torch.int64)
    return mod(e, q)


def crt_combine(r1, r2, q1: int, q2: int):
    """Garner CRT of residue lanes (r1 mod q1, r2 mod q2), q2 < q1 < 2^28 ->
    the int64 residue mod q1*q2: r2 + q2 * ((r1 - r2) * q2^-1 mod q1)."""
    t = (r1 - r2) % q1 * pow(q2, -1, q1) % q1
    return r2 + q2 * t
