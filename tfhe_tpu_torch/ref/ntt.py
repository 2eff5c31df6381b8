"""Exact negacyclic NTT over Z_Q[X]/(X^N + 1) for the host oracle backend.

Replaces the reference's `ChineseRemainderTransformFTTNat`
(`src/core/include/math/hal/intnat/transformnat-impl.h:196-782`): multiply by
powers of the 2N-th root psi (the "twist"), then a size-N cyclic NTT with
omega = psi^2. Pointwise products in the evaluation domain are exactly
negacyclic convolutions, so any internal evaluation ordering yields the same
user-visible (coefficient-domain) results as the reference.

Works on the last axis of uint64 numpy arrays for any NTT prime Q < 2^62
(Montgomery engine above 2^31 — see `modmath`).
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.numtheory import root_of_unity
from . import modmath


@functools.lru_cache(maxsize=None)
def _tables(N: int, Q: int):
    psi = root_of_unity(2 * N, Q)
    psi_inv = pow(psi, -1, Q)
    omega = psi * psi % Q
    omega_inv = pow(omega, -1, Q)
    n_inv = pow(N, -1, Q)

    logn = N.bit_length() - 1
    assert 1 << logn == N

    def powers(base, count):
        out = [1] * count
        for i in range(1, count):
            out[i] = out[i - 1] * base % Q
        return out

    def vec(lst):
        return np.array(lst, dtype=np.uint64)

    def stage_twiddles(w):
        stages = []
        length = 2
        while length <= N:
            stages.append(vec(powers(pow(w, N // length, Q), length // 2)))
            length *= 2
        return stages

    bitrev = np.zeros(N, dtype=np.int64)
    for i in range(N):
        r = 0
        x = i
        for _ in range(logn):
            r = (r << 1) | (x & 1)
            x >>= 1
        bitrev[i] = r

    return {
        "twist": vec(powers(psi, N)),
        "untwist": vec([x * n_inv % Q for x in powers(psi_inv, N)]),
        "fwd_stages": stage_twiddles(omega),
        "inv_stages": stage_twiddles(omega_inv),
        "bitrev": bitrev,
    }


def _cyclic_ntt(x: np.ndarray, stages, bitrev, Q: int) -> np.ndarray:
    m = np.uint64(Q)
    x = x[..., bitrev]
    N = x.shape[-1]
    length = 2
    for tw in stages:
        half = length // 2
        x = x.reshape(x.shape[:-1] + (N // length, length))
        even = x[..., :half]
        odd = modmath.mul(x[..., half:], tw, Q)
        x = np.concatenate([(even + odd) % m, (even + m - odd) % m], axis=-1)
        x = x.reshape(x.shape[:-2] + (N,))
        length *= 2
    return x


def _psi(N: int, Q: int) -> int:
    t = _tables(N, Q)
    return int(t["twist"][1]) if N > 1 else 1


def forward(x: np.ndarray, Q: int) -> np.ndarray:
    """Coefficient -> evaluation domain (negacyclic).

    Routes through the native C++ OpenMP engine (tfhe_tpu_torch/native) when
    available — bit-exact with the numpy path below."""
    N = x.shape[-1]
    from .. import native
    y = np.array(x, dtype=np.uint64, copy=True, order="C")
    if native.ntt_batch(y, Q, _psi(N, Q), inverse=False):
        return y
    t = _tables(N, Q)
    tx = modmath.mul(np.asarray(x, dtype=np.uint64), t["twist"], Q)
    return _cyclic_ntt(tx, t["fwd_stages"], t["bitrev"], Q)


def inverse(x: np.ndarray, Q: int) -> np.ndarray:
    """Evaluation -> coefficient domain (negacyclic)."""
    N = x.shape[-1]
    from .. import native
    y = np.array(x, dtype=np.uint64, copy=True, order="C")
    if native.ntt_batch(y, Q, _psi(N, Q), inverse=True):
        return y
    t = _tables(N, Q)
    y = _cyclic_ntt(np.asarray(x, dtype=np.uint64), t["inv_stages"], t["bitrev"], Q)
    return modmath.mul(y, t["untwist"], Q)


def negacyclic_convolve(a: np.ndarray, b: np.ndarray, Q: int) -> np.ndarray:
    """a * b in Z_Q[X]/(X^N+1) — reference/testing helper."""
    return inverse(modmath.mul(forward(a, Q), forward(b, Q), Q), Q)
