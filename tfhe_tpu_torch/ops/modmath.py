"""Modular arithmetic on int64 torch tensors.

Port of `tfhe_tpu/ops/modmath32.py` and `tfhe_tpu/ops/modmath64.py` (with
`_crt_combine_pair` of `tfhe_tpu/ops/backend.py`). The JAX modules build
everything from exact uint32 primitives because 64-bit multiplies are
untrustworthy on the TPU; torch's uint32 has no add, sub, shift or compare
on the CPU, so these plain versions compute in int64 (products of two values
< 2^28 stay below 2^56) and callers convert to int32 bit patterns only at a
kernel boundary.

Residues mod a prime Q < 2^54 (the two-limb sets) fit int64 as they are, so
the 64-bit functions need no (lo, hi) pairs. What does not fit is the
128-bit product of the Shoup method: `mulhi64` builds its high half from
32-bit halves, and the low halves are int64 products that wrap modulo 2^64.
A Shoup companion floor(b * 2^64 / Q) uses all 64 bits, so it travels as
the int64 view of a u64; its halves are taken with a mask and a masked
shift, never an arithmetic `>>` alone.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


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


def shoup64(b: np.ndarray, Q: int) -> np.ndarray:
    """`shoup64_tensor` on the host, for numpy residues b < Q < 2^54
    (`modmath64.shoup64`): the int64 view of the u64 companions."""
    x = torch.from_numpy(np.asarray(b, dtype=np.uint64).view(np.int64))
    return shoup64_tensor(x, Q).numpy()


def shoup64_tensor(b: torch.Tensor, Q: int) -> torch.Tensor:
    """Shoup companions floor(b 2^64 / Q) of int64 residues b < Q < 2^54,
    exact, on b's device, as the int64 view of their u64 bits. b << 64 does
    not fit, so the quotient is built by long division in 9-bit steps, seven
    of them and one of a bit: every remainder, below Q, shifted left stays
    below 2^63; the quotient's last shift wraps into the sign bit, which is
    the u64 bit."""
    if not 2 <= Q < (1 << 54):
        raise ValueError(f"shoup64_tensor needs Q < 2^54, got {Q}")
    x, quot = b % Q, torch.zeros_like(b)
    for step in (9, 9, 9, 9, 9, 9, 9, 1):
        x = x << step
        digit = x // Q
        quot = (quot << step) + digit
        x = x - digit * Q
    return quot


def mulhi64(a, b):
    """High 64 bits of the 128-bit product of u64 values a, b held as int64
    bit patterns (either may be a Python int < 2^64), as an int64 bit
    pattern. From the four products of 32-bit halves: each is below 2^64,
    so its int64 product has the right bits, and the column sums are exact
    modulo 2^64. The sums go in place into the products' own fresh tensors,
    which on the CPU takes about a third off the time of the plain 64-bit
    rotation's hottest function."""
    a0, a1 = a & _M32, (a >> 32) & _M32
    b0, b1 = b & _M32, (b >> 32) & _M32
    p01, p10 = a0 * b1, a1 * b0
    mid = (a0 * b0 >> 32) & _M32
    mid += p01 & _M32
    mid += p10 & _M32                                               # < 3 * 2^32
    hi = a1 * b1
    p01 >>= 32
    p01 &= _M32
    hi += p01
    p10 >>= 32
    p10 &= _M32
    hi += p10
    mid >>= 32
    hi += mid
    return hi


def mulmod_shoup64_lazy(a, w, w_sh, Q: int):
    """a * w mod Q + {0, Q} for any u64 a (int64 bits), w < Q < 2^62 and its
    companion w_sh = floor(w * 2^64 / Q): q_hat = hi64(a * w_sh), then
    a * w - q_hat * Q, whose true value lies in [0, 2Q), computed in int64
    arithmetic that wraps modulo 2^64 (`pallas_rotate64._mulmod_shoup64_lazy`)."""
    return a * w - mulhi64(a, w_sh) * Q


def mulmod_shoup64(a, w, w_sh, Q: int):
    """a * w mod Q in [0, Q) (`modmath64.mulmod_shoup64`)."""
    r = mulmod_shoup64_lazy(a, w, w_sh, Q)
    return torch.where(r >= Q, r - Q, r)


def shoup64_values(w_sh, Q: int):
    """The values w < Q rebuilt from their companions w_sh (int64 bits):
    w * 2^64 = w_sh * Q + (w * 2^64 mod Q), so w = hi64(w_sh * Q) plus one
    unless lo64(w_sh * Q) is 0 (`pallas_rotate64.py:182-191`)."""
    return mulhi64(w_sh, Q) + ((w_sh * Q) != 0).to(torch.int64)
