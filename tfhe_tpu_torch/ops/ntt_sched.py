"""Permutation-free negacyclic NTT schedules for the fused Pallas kernel.

The lane-oriented kernel wants NTT stages expressed as full-width vector ops
(roll + multiply + select) with *no* gather/permutation anywhere in the hot
loop. That rules out the bit-reversal step of the textbook iterative NTT
(ref/ntt.py, mirroring `transformnat-impl.h`). Instead:

- forward = twist by psi^j, then Gentleman-Sande (DIF) stages with
  half = N/2 .. 1: natural input -> **bit-reversed evaluation order**;
- inverse = Cooley-Tukey (DIT) stages with half = 1 .. N/2 consuming
  bit-reversed order -> natural output, then untwist by psi^-j / N.

Pointwise products commute with any fixed reordering, so key material only
has to be stored in the same bit-reversed evaluation order (a one-time host
permutation of the canonical evaluation-domain key).

Each stage is described by one full-length multiplier vector W[N] (+ Shoup
companion) positioned at the *odd-half* lanes, so a stage is exactly:

    DIF:  t = mulmod(roll(x, h) - x, W);  s = x + roll(x, -h)
          x = where(odd_half, t, s)
    DIT:  t = mulmod(x, W)                (meaningful at odd-half lanes)
          x = where(odd_half, roll(x, h) - t, x + roll(t, -h))

`apply_*_np` mirror the kernel ops in numpy and are tested bit-exact against
ref/ntt.py (forward up to the bit-reversal permutation, inverse exactly).
"""

from __future__ import annotations

import functools

import numpy as np

from ..ref import ntt as ref_ntt
from ..ref import modmath as ref_mm


@functools.lru_cache(maxsize=None)
def schedule(N: int, Q: int):
    """Stage multiplier vectors for (N, Q).

    Returns dict with uint64 numpy arrays:
      twist [N], untwist [N] (N^-1 folded in),
      fwd_w [logN, N]  (stage k has half = N >> (k+1)),
      inv_w [logN, N]  (stage k has half = 1 << k),
      bitrev [N] int64 (natural -> bit-reversed eval order mapping).
    """
    t = ref_ntt._tables(N, Q)
    logn = N.bit_length() - 1
    psi = int(t["twist"][1]) if N > 1 else 1
    omega = psi * psi % Q
    omega_inv = pow(omega, -1, Q)

    pos = np.arange(N, dtype=np.int64)

    def stage_vec(base: int, h: int) -> np.ndarray:
        """Multiplier vector for a stage with block length L = 2h: odd-half
        lane p (pair index t = p mod L - h) carries base^{t * N/L}."""
        L = 2 * h
        j = pos % L
        e = np.where(j >= h, (j - h) * (N // L), 0)
        return np.array([pow(base, int(x), Q) for x in e], dtype=np.uint64)

    fwd_w = np.stack([stage_vec(omega, N >> (k + 1)) for k in range(logn)])
    inv_w = np.stack([stage_vec(omega_inv, 1 << k) for k in range(logn)])

    return {
        "twist": t["twist"],
        "untwist": t["untwist"],
        "fwd_w": fwd_w,
        "inv_w": inv_w,
        "bitrev": t["bitrev"],
    }


def _roll(x: np.ndarray, s: int) -> np.ndarray:
    return np.roll(x, s, axis=-1)


def apply_forward_np(x: np.ndarray, N: int, Q: int) -> np.ndarray:
    """Twist + DIF stages in numpy; output in bit-reversed evaluation order.

    Bit-exact identity: apply_forward_np(x)[..., bitrev] == ref_ntt.forward(x).
    """
    sch = schedule(N, Q)
    m = np.uint64(Q)
    pos = np.arange(N)
    x = ref_mm.mul(np.asarray(x, dtype=np.uint64), sch["twist"], Q)
    logn = N.bit_length() - 1
    for k in range(logn):
        h = N >> (k + 1)
        odd = (pos % (2 * h)) >= h
        d = (_roll(x, h) + m - x) % m
        t = ref_mm.mul(d, sch["fwd_w"][k], Q)
        s = (x + _roll(x, -h)) % m
        x = np.where(odd, t, s)
    return x


def apply_inverse_np(x: np.ndarray, N: int, Q: int) -> np.ndarray:
    """DIT stages + untwist in numpy; input in bit-reversed evaluation order.

    Bit-exact identity: apply_inverse_np(y) == ref_ntt.inverse(y[..., bitrev]).
    """
    sch = schedule(N, Q)
    m = np.uint64(Q)
    pos = np.arange(N)
    x = np.asarray(x, dtype=np.uint64)
    logn = N.bit_length() - 1
    for k in range(logn):
        h = 1 << k
        odd = (pos % (2 * h)) >= h
        t = ref_mm.mul(x, sch["inv_w"][k], Q)
        x = np.where(odd, (_roll(x, h) + m - t) % m, (x + _roll(t, -h)) % m)
    return ref_mm.mul(x, sch["untwist"], Q)
