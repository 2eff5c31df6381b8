"""RingGSW accumulators (blind rotation) — exact host oracle.

Mirrors:
- `RingGSWAccumulator::SignedDigitDecompose` (rgsw-acc.cpp:57-111),
- CGGI/GINX keygen + accumulation (rgsw-acc-cggi.cpp:43-307),
- DM/AP keygen + accumulation (rgsw-acc-dm.cpp:43-359),
- the transpose automorphism a(X) -> a(X^{2N-1}) (poly.cpp:664-770).

Keys are stored canonically in the COEFFICIENT domain as dense arrays
(uint64; the Montgomery engine in `modmath` keeps 54-bit primes exact); evaluation-domain copies are built
once per backend at setup time — the analogue of the reference's GPUSetup key
conversion (bootstrapping.cu:931-959).

Mathematical note: the reference multiplies by the monomial (X^a - 1) in the
evaluation domain via precomputed tables (rgsw-cryptoparameters.h:141-159).
Because our arithmetic is exact (NTT, not FFT), we may instead apply the
monomial in the coefficient domain as a negacyclic rotate-and-subtract, and
keep the accumulator in the coefficient domain between rounds; the result is
bit-identical to the reference's NTT ("bit-exactness oracle") path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params import Method, RGSWParams
from ..utils.rng import BinFHERng
from . import modmath, ntt


# ---------------------------------------------------------------------------
# digit decomposition
# ---------------------------------------------------------------------------

def signed_digit_decompose(params: RGSWParams, input_2xN: np.ndarray) -> np.ndarray:
    """[2, N] residues mod Q -> [digitsG2, N] balanced signed digits as residues
    mod Q; digit l of poly j lands in row j + 2*l (rgsw-acc.cpp:57-111).

    Low `num_digits_to_throw` digits are computed and discarded (approximate
    gadget decomposition).
    """
    Q = params.Q
    base_g = params.base_g
    g_bits = base_g.bit_length() - 1
    digits_g = params.digits_g - params.num_digits_to_throw

    d = modmath.to_signed(np.asarray(input_2xN), Q, half_negative=True)  # int64

    half = base_g >> 1
    out = np.zeros((2 * digits_g,) + d.shape[1:], dtype=np.int64)

    def extract(d):
        # sign-extended low g_bits: equivalent to (d << (64-g)) >> (64-g)
        r = d & (base_g - 1)
        r = np.where(r >= half, r - base_g, r)
        return r, (d - r) >> g_bits

    for _ in range(params.num_digits_to_throw):
        _, d = extract(d)
    for l in range(digits_g):
        r, d = extract(d)
        out[2 * l] = r[0]
        out[2 * l + 1] = r[1]
    return modmath.from_signed(out, Q)


# ---------------------------------------------------------------------------
# polynomial helpers
# ---------------------------------------------------------------------------

def negacyclic_monomial_mul(poly: np.ndarray, m: int, Q: int) -> np.ndarray:
    """X^m * poly in Z_Q[X]/(X^N+1), m in [0, 2N)."""
    N = poly.shape[-1]
    neg = False
    m = m % (2 * N)
    if m >= N:
        m -= N
        neg = True
    rolled = np.roll(poly, m, axis=-1)
    if m > 0:
        rolled = rolled.copy()
        sl = [slice(None)] * (rolled.ndim - 1) + [slice(0, m)]
        rolled[tuple(sl)] = (Q - rolled[tuple(sl)]) % _mod(poly, Q)
    if neg:
        rolled = (Q - rolled) % _mod(poly, Q)
    return rolled


def poly_transpose(poly_coeff: np.ndarray, Q: int) -> np.ndarray:
    """a(X) -> a(X^{2N-1}) = a(X^{-1}) in the coefficient domain:
    out[0] = a[0], out[i] = -a[N-i] (poly.cpp:716-738 with k = 2N-1)."""
    out = poly_coeff.copy()
    rev = poly_coeff[..., ::-1]
    out[..., 1:] = (Q - rev[..., :-1]) % _mod(poly_coeff, Q)
    return out


def _mod(arr: np.ndarray, Q: int):
    return Q if arr.dtype == object else np.uint64(Q)


# ---------------------------------------------------------------------------
# CGGI (GINX)
# ---------------------------------------------------------------------------

def keygen_cggi(rng: BinFHERng, params: RGSWParams, sk_n_ntt: np.ndarray, m: int) -> np.ndarray:
    """One RGSW encryption of `m` in {0,1}: [digitsG2, 2, N] coefficient domain
    (rgsw-acc-cggi.cpp:213-240). Gadget power Gpow[(i>>1)+throw] is added to the
    a-part of even rows / b-part of odd rows at coefficient 0."""
    Q, N = params.Q, params.N
    d2 = params.digits_g2
    g_pow = params.g_power
    throw = params.num_digits_to_throw

    a = rng.discrete_uniform(d2 * N, Q).reshape(d2, N).astype(np.uint64)
    e = rng.discrete_gaussian(d2 * N, params.std, Q).reshape(d2, N).astype(np.uint64)
    # b = a*s + e in the coefficient domain
    a_hat = ntt.forward(a, Q)
    b = ntt.inverse(modmath.mul(a_hat, sk_n_ntt, Q), Q)
    b = (b + e) % np.uint64(Q)

    rows = np.stack([a, b], axis=1)
    if m:
        for i in range(d2):
            g = g_pow[(i >> 1) + throw]
            rows[i, i & 1, 0] = (rows[i, i & 1, 0] + np.uint64(g)) % np.uint64(Q)
    return rows


def keygen_acc_cggi(rng: BinFHERng, params: RGSWParams, sk_n_ntt: np.ndarray,
                    lwe_sk_signed: np.ndarray, ring_mul=None) -> np.ndarray:
    """Bootstrapping key for ternary LWE secrets: [n, 2, digitsG2, 2, N].
    s=0 -> (E(0), E(0)); s=1 -> (E(1), E(0)); s=-1 -> (E(0), E(1))
    (rgsw-acc-cggi.cpp:43-77).

    All 2n RGSW encryptions are generated in ONE vectorized pass (single RNG
    block draw, one batched forward/inverse NTT through the native engine)
    instead of a 2n-iteration Python loop — same distribution, ~an order of
    magnitude faster at production n. `ring_mul`, when given, maps the
    uniform rows a [R, N] to a * s mod (Q, X^N + 1) in place of the host
    NTTs (`ops/keygen.ring_mul`: the same words, on a device)."""
    n = len(lwe_sk_signed)
    d2 = params.digits_g2
    N, Q = params.N, params.Q
    R = n * 2 * d2
    a = rng.discrete_uniform(R * N, Q).reshape(R, N).astype(np.uint64, copy=False)
    e = rng.discrete_gaussian(R * N, params.std, Q).reshape(R, N).astype(np.uint64, copy=False)
    if ring_mul is None:
        b = ntt.inverse(modmath.mul(ntt.forward(a, Q), sk_n_ntt[None, :], Q), Q)
    else:
        b = ring_mul(a)
    b += e                                                  # b, e < Q: one subtraction
    np.subtract(b, np.uint64(Q), out=b, where=b >= np.uint64(Q))
    bsk = np.stack([a.reshape(n, 2, d2, N), b.reshape(n, 2, d2, N)],
                   axis=3)                                  # [n, 2, d2, 2, N]
    # gadget powers on the diagonal rows of the encrypted-1 halves:
    # part 0 encrypts 1 where s == +1, part 1 where s == -1
    s = np.asarray(lwe_sk_signed, dtype=np.int64)
    g_pow = params.g_power
    throw = params.num_digits_to_throw
    uq = np.uint64(Q)
    for part, val in ((0, 1), (1, -1)):
        idx = np.nonzero(s == val)[0]
        for j in range(d2):
            g = np.uint64(g_pow[(j >> 1) + throw])
            bsk[idx, part, j, j & 1, 0] = \
                (bsk[idx, part, j, j & 1, 0] + g) % uq
    return bsk


@dataclass
class CGGIEvalKey:
    """Evaluation-domain bootstrapping key (built once from the canonical
    coefficient-domain key, like the reference's GPUSetup FFT conversion)."""
    bsk_hat: np.ndarray  # [n, 2, digitsG2, 2, N] eval domain


def to_eval_cggi(params: RGSWParams, bsk_coeff: np.ndarray) -> CGGIEvalKey:
    return CGGIEvalKey(bsk_hat=ntt.forward(bsk_coeff, params.Q))


def add_to_acc_cggi(params: RGSWParams, ek1_hat: np.ndarray, ek2_hat: np.ndarray,
                    a_scaled: int, acc_coeff: np.ndarray) -> np.ndarray:
    """One blind-rotation round (rgsw-acc-cggi.cpp:246-307).

    acc += (X^a - 1) * <dct, ek1> + (X^{-a} - 1) * <dct, ek2>, all mod
    (Q, X^N + 1); `a_scaled` already carries the 2N/q embedding factor.
    """
    Q = params.Q
    M = 2 * params.N
    d2 = params.digits_g2
    m = _mod(acc_coeff, Q)

    dct = signed_digit_decompose(params, acc_coeff)              # [digitsG2, N]
    dct_hat = ntt.forward(dct, Q)

    idx_pos = a_scaled % M
    idx_neg = (M - idx_pos) % M

    for ek_hat, idx in ((ek1_hat, idx_pos), (ek2_hat, idx_neg)):
        for j in range(2):
            u = modmath.mul(dct_hat, ek_hat[:, j, :], Q)          # [digitsG2, N]
            u = _sum_mod(u, Q)
            c = ntt.inverse(u, Q)
            rot = negacyclic_monomial_mul(c, idx, Q)
            acc_coeff[j] = (acc_coeff[j] + rot + (Q - c)) % m
    return acc_coeff


def _sum_mod(u: np.ndarray, Q: int) -> np.ndarray:
    # uint64 lane sums: digitsG2 <= 16 terms, each < Q <= 2^54 — no overflow
    return u.sum(axis=0) % np.uint64(Q)


def eval_acc_cggi(params: RGSWParams, ek: CGGIEvalKey, acc_coeff: np.ndarray,
                  a_vec: np.ndarray, a_modulus: int) -> np.ndarray:
    """Full blind rotation over the n LWE coefficients (rgsw-acc-cggi.cpp:143-155):
    round i uses index (q - a_i mod q) * (2N / q).

    Routes through the native C++ engine (tfhe_tpu_torch/native) when available and
    the base is a power of two — bit-exact with the numpy loop below. A Python-int
    (object) accumulator, which the scheme builds for Q >= 2^31, goes there as
    uint64 too (Q < 2^62) and comes back as Python ints."""
    M = 2 * params.N
    factor = M // a_modulus
    n = len(a_vec)
    Q, base_g = params.Q, params.base_g
    if base_g & (base_g - 1) == 0 and Q < (1 << 62):
        from .. import native
        a_scaled = ((np.int64(a_modulus)
                     - np.asarray(a_vec, dtype=np.int64) % a_modulus)
                    % a_modulus) * factor
        acc = np.ascontiguousarray(acc_coeff[None], dtype=np.uint64)
        if native.cggi_rotate(acc, a_scaled[None], ek.bsk_hat, Q,
                              ntt._psi(params.N, Q),
                              base_g.bit_length() - 1,
                              params.digits_g - params.num_digits_to_throw,
                              params.num_digits_to_throw):
            return acc[0].astype(acc_coeff.dtype)
    for i in range(n):
        a_scaled = int((a_modulus - int(a_vec[i])) % a_modulus) * factor
        acc_coeff = add_to_acc_cggi(params, ek.bsk_hat[i, 0], ek.bsk_hat[i, 1],
                                    a_scaled, acc_coeff)
    return acc_coeff


# ---------------------------------------------------------------------------
# DM (AP / FHEW)
# ---------------------------------------------------------------------------

def keygen_dm(rng: BinFHERng, params: RGSWParams, sk_n_ntt: np.ndarray, m: int) -> np.ndarray:
    """RGSW encryption of X^m * G for the DM accumulator
    (rgsw-acc-dm.cpp:153-209). `m` may be any signed integer; it is reduced mod
    q, scaled by 2N/q, and X^{mm} with mm >= N flips sign (negacyclic)."""
    return keygen_dm_batch(rng, params, sk_n_ntt, [m])[0]


def keygen_dm_batch(rng: BinFHERng, params: RGSWParams, sk_n_ntt: np.ndarray,
                    ms: list[int]) -> np.ndarray:
    """`keygen_dm` of each m of `ms`, [len(ms), digitsG2, 2, N]: the same
    randomness in the same order (a, then e, m by m), the transforms and
    the gadget additions batched."""
    Q, N, q = params.Q, params.N, params.q
    digits_g = params.digits_g
    d2 = 2 * digits_g
    g_pow = params.g_power
    C = len(ms)

    a = np.empty((C, d2, N), dtype=np.uint64)
    e = np.empty((C, d2, N), dtype=np.uint64)
    for c in range(C):
        a[c] = rng.discrete_uniform(d2 * N, Q).reshape(d2, N)
        e[c] = rng.discrete_gaussian(d2 * N, params.std, Q).reshape(d2, N)
    a_hat = ntt.forward(a, Q)
    b = ntt.inverse(modmath.mul(a_hat, sk_n_ntt, Q), Q)
    b = (b + e) % np.uint64(Q)
    rows = np.stack([a, b], axis=2)                         # [C, d2, 2, N]

    mm = np.array([((m % q) + q) % q * (2 * N // q) for m in ms], dtype=np.int64)
    is_reduced = mm >= N
    mm[is_reduced] -= N
    c = np.arange(C)
    mQ = np.uint64(Q)
    for i in range(digits_g):
        g = np.uint64(g_pow[i])
        add = np.where(is_reduced, mQ - g, g)
        rows[c, 2 * i, 0, mm] = (rows[c, 2 * i, 0, mm] + add) % mQ
        rows[c, 2 * i + 1, 1, mm] = (rows[c, 2 * i + 1, 1, mm] + add) % mQ
    return rows


# DM key entries encrypted per batch of `keygen_dm_batch` (~100 MB of u64 a
# batch at N = 1024, d2 = 6)
_DM_KEYGEN_BATCH = 2048


def keygen_acc_dm(rng: BinFHERng, params: RGSWParams, sk_n_ntt: np.ndarray,
                  lwe_sk_signed: np.ndarray) -> np.ndarray:
    """DM bootstrapping key [n, baseR, digitsR, digitsG2, 2, N]; entry [i][j][k]
    encrypts X^{s_i * j * baseR^k} * G; j = 0 is unused (rgsw-acc-dm.cpp:43-78).
    Note: DM ignores num_digits_to_throw (the reference's approximate
    decomposition is CGGI-only). The entries are drawn in the order i, j,
    k, in batches."""
    n = len(lwe_sk_signed)
    base_r = params.base_r
    digits_r = params.digits_r
    d2 = 2 * params.digits_g
    bsk = np.zeros((n, base_r, len(digits_r), d2, 2, params.N), dtype=np.uint64)
    entries = [(i, j, k) for i in range(n) for j in range(1, base_r)
               for k in range(len(digits_r))]
    for c0 in range(0, len(entries), _DM_KEYGEN_BATCH):
        batch = entries[c0:c0 + _DM_KEYGEN_BATCH]
        ms = [int(lwe_sk_signed[i]) * j * int(digits_r[k]) for i, j, k in batch]
        ii, jj, kk = (np.array(x) for x in zip(*batch))
        bsk[ii, jj, kk] = keygen_dm_batch(rng, params, sk_n_ntt, ms)
    return bsk


@dataclass
class DMEvalKey:
    bsk_hat: np.ndarray  # [n, baseR, digitsR, digitsG2, 2, N] eval domain


def to_eval_dm(params: RGSWParams, bsk_coeff: np.ndarray) -> DMEvalKey:
    return DMEvalKey(bsk_hat=ntt.forward(bsk_coeff, params.Q))


def add_to_acc_dm(params: RGSWParams, ek_hat: np.ndarray, acc_coeff: np.ndarray) -> np.ndarray:
    """One DM accumulation: acc <- <dct, ek> (replacing acc), with the sum over
    gadget rows starting at l = 1 exactly as the reference does
    (rgsw-acc-dm.cpp:350-358)."""
    Q = params.Q
    m = _mod(acc_coeff, Q)
    # DM uses the full digitsG (no thrown digits)
    d2 = 2 * params.digits_g
    saved_throw = params.num_digits_to_throw
    assert saved_throw == 0 or params.method == Method.AP
    dct = signed_digit_decompose(params, acc_coeff)
    dct_hat = ntt.forward(dct, Q)

    out = np.zeros_like(acc_coeff)
    for j in range(2):
        u = modmath.mul(dct_hat[1:], ek_hat[1:d2, j, :], Q)
        u = _sum_mod(u, Q)
        out[j] = ntt.inverse(u, Q)
    return out


def eval_acc_dm(params: RGSWParams, ek: DMEvalKey, acc_coeff: np.ndarray,
                a_vec: np.ndarray, a_modulus: int) -> np.ndarray:
    """DM blind rotation (rgsw-acc-dm.cpp:80-110): base-R digits of (q - a_i),
    zero digits skipped."""
    base_r = params.base_r
    digits_r = params.digits_r
    q = a_modulus
    for i in range(len(a_vec)):
        a_i = (q - int(a_vec[i])) % q
        for k in range(len(digits_r)):
            a0 = a_i % base_r
            a_i //= base_r
            if a0:
                acc_coeff = add_to_acc_dm(params, ek.bsk_hat[i, a0, k], acc_coeff)
    return acc_coeff
