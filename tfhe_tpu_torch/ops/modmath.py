"""Modular arithmetic on int64 torch tensors (moduli < 2^31).

Port of `tfhe_tpu/ops/modmath32.py`. The JAX module builds everything from
exact uint32 primitives because 64-bit multiplies are untrustworthy on the
TPU; torch's uint32 has no add, sub, shift or compare on the CPU, so these
plain versions compute in int64 (products of two values < 2^28 stay below
2^56) and callers convert to int32 bit patterns only at a kernel boundary.
"""

from __future__ import annotations


def addmod(a, b, Q: int):
    return (a + b) % Q


def submod(a, b, Q: int):
    return (a - b) % Q


def negmod(a, Q: int):
    return (-a) % Q


def mod(x, Q: int):
    """x mod Q in [0, Q) for any int64 x."""
    return x % Q


def shoup(b, Q: int):
    """Shoup companion floor(b * 2^32 / Q) of residues b < Q < 2^31."""
    return (b << 32) // Q


def round_q_Q(v, q: int, Q: int):
    """RoundqQ (lwe-pke.cpp:41-46) as the exact rational round-half-up
    floor((2vq + Q) / (2Q)) mod q, for v < Q < 2^31 and q <= Q; 2vq + Q
    stays below 2^63."""
    if q == Q:
        return v
    return (2 * v * q + Q) // (2 * Q) % q

