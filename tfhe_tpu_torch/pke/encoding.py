"""Plaintext encodings for the pke schemes.

Port of `tfhe_tpu/pke/encoding.py`, the counterpart of the reference's
`src/pke/lib/encoding` (packedencoding.cpp): the packed (SIMD/slot) encoding
maps a vector of N values mod a prime plaintext modulus t = 1 (mod 2N) to a
polynomial via the inverse negacyclic NTT mod t, so that ring multiplication
acts slot-wise and the Galois automorphism X -> X^(5^i) rotates slots.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..ref import ntt as ref_ntt


def supports_packing(t: int, N: int) -> bool:
    return t % (2 * N) == 1


def pack(values, t: int, N: int) -> np.ndarray:
    """Slot values [<= N] mod t -> coefficient vector [N] mod t."""
    assert supports_packing(t, N), "packed encoding needs prime t = 1 mod 2N"
    v = np.zeros(N, dtype=np.uint64)
    arr = np.asarray(values, dtype=np.int64) % t
    v[:arr.size] = arr.astype(np.uint64)
    perm = _slot_perm(t, N)
    slots = np.zeros(N, dtype=np.uint64)
    slots[perm] = v
    return ref_ntt.inverse(slots, t)


def unpack(coeffs, t: int, N: int) -> np.ndarray:
    """Coefficient vector [N] mod t -> slot values [N]."""
    slots = ref_ntt.forward(np.asarray(coeffs, dtype=np.uint64) % np.uint64(t), t)
    return slots[_slot_perm(t, N)].astype(np.int64)


@lru_cache(maxsize=None)
def _slot_perm(t: int, N: int) -> np.ndarray:
    """Order evaluation points by powers of the rotation generator g = 5:
    slot i holds the evaluation at psi^(5^i mod 2N), so the automorphism
    X -> X^5 is a cyclic rotation of the first N/2 slots (and of the second
    half), matching the reference's packed-encoding slot order
    (packedencoding.cpp, `m_toCRTPerm`)."""
    # ref_ntt.forward index k holds the evaluation at psi^(2k+1)
    # (verified numerically; see tests/test_pke_packed.py)
    pos_of_exp = {(2 * k + 1) % (2 * N): k for k in range(N)}
    perm = np.zeros(N, dtype=np.int64)
    g = 1
    for i in range(N // 2):
        perm[i] = pos_of_exp[g]                   # exponent 5^i
        perm[i + N // 2] = pos_of_exp[2 * N - g]  # conjugate orbit
        g = (g * 5) % (2 * N)
    return perm


def rotation_automorphism_index(N: int, steps: int) -> int:
    """The Galois element k with X -> X^k rotating packed slots by `steps`."""
    return pow(5, steps % (N // 2), 2 * N)


def apply_automorphism_coeff(coeffs: np.ndarray, k: int, modulus: int) -> np.ndarray:
    """a(X) -> a(X^k) in Z_m[X]/(X^N+1), coefficient domain
    (poly.cpp:664-759 AutomorphismTransform)."""
    N = coeffs.shape[-1]
    out = np.zeros_like(coeffs)
    idx = (np.arange(N) * k) % (2 * N)
    tgt = idx % N
    sign_flip = idx >= N
    m = np.uint64(modulus)
    vals = np.where(sign_flip & (coeffs != 0), m - coeffs, coeffs)
    out[..., tgt] = vals
    return out


def encode_string(s: str, t: int, N: int) -> np.ndarray:
    """StringEncoding (stringencoding.cpp): one character code per
    coefficient, zero-padded; requires t >= 256 and len(s) <= N."""
    assert t >= 256 and len(s) <= N
    out = np.zeros(N, dtype=np.int64)
    b = s.encode("utf-8")
    assert len(b) <= N
    out[:len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def decode_string(coeffs, t: int, N: int) -> str:
    v = np.asarray(coeffs, dtype=np.int64) % t
    b = bytes(int(x) for x in v if 0 < x < 256)
    return b.decode("utf-8", errors="replace")
