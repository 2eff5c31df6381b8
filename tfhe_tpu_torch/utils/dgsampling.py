"""Lattice Gaussian sampling subroutines for trapdoor preimages.

Port of `tfhe_tpu/utils/dgsampling.py`: the same numpy host code, on
the port's `field2n` and `dgg_generic`; the same samples on the same seed
(tests/test_torch_lattice.py).

Counterpart of the reference's `LatticeGaussSampUtility`
(`src/core/lib/lattice/dgsampling.cpp:50-513`, header `dgsampling.h`):

- ``gauss_samp_gq``: exact G-lattice sampling for an arbitrary modulus q
  (Figure 2 of https://eprint.iacr.org/2017/308, the *discrete* perturbation
  variant, dgsampling.cpp:50-118). The reference runs an OpenMP loop with
  one scalar Karney call per (coefficient, digit); here each digit level is
  ONE vector-center Karney batch over all n coefficients (the sequential
  dependence is across the k digit levels only).
- ``zsample_sigma_2x2`` / ``zsample_f``: the recursive Fourier-domain
  sampler for covariances given as field elements (Algorithm 4 of
  https://eprint.iacr.org/2017/844; dgsampling.cpp:262-306, 415-446),
  on utils/field2n.py elements.
- ``sample_pz``: the 2x2-block perturbation sampler for MP12 trapdoors
  (``RLWETrapdoorUtility::ZSampleSigmaP``, trapdoor.cpp:111-268): builds
  the Schur-complement covariance from the trapdoor pair (r, e) in the
  Fourier domain and returns the (k+2)-vector of perturbation polynomials.

Constants (dgsampling.h:54-69): SIGMA is the smoothing-parameter width and
SPECTRAL_BOUND(n, k, base) the operator-norm bound s used for perturbation.
"""

from __future__ import annotations

import numpy as np

from .dgg_generic import karney
from .field2n import COEFF, EVAL, Field2n, inverse_permute_ints

DG_ERROR = 8.27181e-25
N_MAX = 16384
SIGMA = float(np.sqrt(np.log(2 * N_MAX / DG_ERROR) / np.pi))
SPECTRAL_CONSTANT = 1.8


def spectral_bound(n: int, k: int, base: int) -> float:
    """SPECTRAL_BOUND (dgsampling.h:61-64)."""
    return SPECTRAL_CONSTANT * (base + 1) * SIGMA * SIGMA * (
        np.sqrt(n * k) + np.sqrt(2 * n) + 4.7)


def _digits(v: int, base: int, k: int) -> np.ndarray:
    d = np.empty(k, dtype=np.int64)
    for i in range(k):
        d[i] = v % base
        v //= base
    return d


def gauss_samp_gq(v: np.ndarray, stddev: float, k: int, q: int, base: int,
                  rng, continuous: bool = False) -> np.ndarray:
    """Sample z [k, n] with sum_t base^t z[t] == v (mod q), each entry
    Gaussian of width ~stddev (GaussSampGq, dgsampling.cpp:50-118).

    v: [n] nonnegative residues mod q; rng: anything with .random(m)
    (np.random.Generator or BinFHERng). Vectorized over the n coefficients;
    the k digit levels are sequential (their centers chain).

    ``continuous=True`` switches the perturbation stage to the continuous
    variant (GaussSampGqArbBase / PerturbFloat, dgsampling.cpp:125-247,
    Algorithm 3 of eprint 2017/844) — the form the reference's online
    GaussSamp calls; the discrete default is the eprint 2017/308 Figure 2
    sampler."""
    v = np.asarray(v, dtype=object)
    n = v.shape[0]
    sigma = stddev / (base + 1)
    if k < 2:
        raise ValueError("gauss_samp_gq requires k >= 2")

    m_digits = _digits(int(q), base, k).astype(np.float64)
    # Cholesky bands of the G-lattice basis (dgsampling.cpp:64-77)
    l = np.empty(k)
    h = np.empty(k)
    l[0] = np.sqrt(base * (1 + 1.0 / k) + 1)
    for i in range(1, k):
        l[i] = np.sqrt(base * (1 + 1.0 / (k - i)))
    h[0] = 0.0
    for i in range(1, k):
        h[i] = np.sqrt(base * (1 - 1.0 / (k - (i - 1))))
    # c depends only on the modulus (dgsampling.cpp:80-85)
    c = np.empty(k)
    c[0] = m_digits[0] / base
    for i in range(1, k):
        c[i] = (c[i - 1] + m_digits[i]) / base

    if continuous:
        # PerturbFloat (dgsampling.cpp:225-247): continuous N(0, sigma) via
        # Box-Muller on the shared uniform stream, then the L-band transform
        u1 = np.maximum(rng.random(k * n), np.finfo(np.float64).tiny)
        u2 = rng.random(k * n)
        zc = (np.sqrt(-2.0 * np.log(u1)) * np.cos(2 * np.pi * u2)
              ).reshape(k, n) * sigma
        p = np.empty((k, n))
        for i in range(k - 1):
            p[i] = l[i] * zc[i] + h[i + 1] * zc[i + 1]
        p[k - 1] = h[k - 1] * zc[k - 1]
    else:
        # Perturb (dgsampling.cpp:199-221), all coefficients at once: z_i has
        # center d/l_i with d = -z_{i-1} h_i -> vector-center Karney per level
        zp = np.empty((k, n), dtype=np.int64)
        d = np.zeros(n)
        for i in range(k):
            zp[i] = karney(rng, d / l[i], sigma / l[i])
            d = -zp[i] * h[i]
        p = np.empty((k, n), dtype=np.int64)
        p[0] = (2 * base + 1) * zp[0] + base * zp[1]
        for i in range(1, k - 1):
            p[i] = base * (zp[i - 1] + 2 * zp[i] + zp[i + 1])
        p[k - 1] = base * (zp[k - 2] + 2 * zp[k - 1])

    v_digits = np.stack([_digits(int(x), base, k) for x in v], axis=1)
    # a chain (dgsampling.cpp:99-105)
    a = np.empty((k, n))
    a[0] = (v_digits[0] - p[0]) / base
    for t in range(1, k):
        a[t] = (a[t - 1] + v_digits[t] - p[t]) / base

    # SampleC (dgsampling.cpp:248-259)
    zj = np.empty((k, n), dtype=np.int64)
    zj[k - 1] = karney(rng, -a[k - 1] / c[k - 1], sigma / c[k - 1])
    a = a + zj[k - 1][None, :].astype(np.float64) * c[:, None]
    for i in range(k - 1):
        zj[i] = karney(rng, -a[i], sigma)

    # reassemble z (dgsampling.cpp:108-117)
    z = np.empty((k, n), dtype=np.int64)
    md = m_digits.astype(np.int64)
    z[0] = base * zj[0] + md[0] * zj[k - 1] + v_digits[0]
    for t in range(1, k - 1):
        z[t] = base * zj[t] - zj[t - 1] + md[t] * zj[k - 1] + v_digits[t]
    z[k - 1] = md[k - 1] * zj[k - 1] - zj[k - 2] + v_digits[k - 1]
    return z


def zsample_f(f: Field2n, c: Field2n, rng) -> np.ndarray:
    """Sample an integer vector with covariance given by the field element f
    and center c, both in COEFFICIENT format (ZSampleF,
    dgsampling.cpp:415-446): recursive even/odd Fourier splitting down to
    scalar Karney draws."""
    if f.n == 1:
        val = karney(rng, float(c.v[0].real),
                     float(np.sqrt(max(f.v[0].real, 1e-12))), 1)
        return val.astype(np.int64)
    f0 = f.extract_even().to_eval()
    f1 = f.extract_odd().to_eval()
    q = zsample_sigma_2x2(f0, f1, f0, (c.extract_even(), c.extract_odd()),
                          rng)
    return inverse_permute_ints(q)


def zsample_sigma_2x2(a: Field2n, b: Field2n, d: Field2n,
                      c: tuple[Field2n, Field2n], rng) -> np.ndarray:
    """Sample [q1; q2] (2n ints) for the block covariance [[a, b], [b^T, d]]
    with centers (c0, c1) in COEFFICIENT format (ZSampleSigma2x2,
    dgsampling.cpp:262-306). a, b, d are in EVALUATION format."""
    q2 = zsample_f(d.to_coeff(), c[1], rng)

    q2_minus_c2 = (Field2n(q2.astype(np.float64)) - c[1]).to_eval()
    product = (b * d.inverse() * q2_minus_c2).to_coeff()
    c1 = c[0] + product

    fld = (a - b * d.inverse() * b.transpose()).to_coeff()
    q1 = zsample_f(fld, c1, rng)
    return np.concatenate([q1, q2])


def sample_pz(n: int, s: float, sigma: float, e: np.ndarray, r: np.ndarray,
              Q: int, rng) -> np.ndarray:
    """MP12 perturbation vector p [k+2, n] for trapdoor (r, e)
    (ZSampleSigmaP, trapdoor.cpp:111-268).

    e, r: [k, n] signed trapdoor polynomials; s the spectral bound; sigma
    the G-sampling width ((base+1)*SIGMA). Covariance is
    s^2*I - sigma^2 * [[1+ee^T, er^T],[re^T, 1+rr^T]]-ish via the
    Schur-complement construction in the Fourier domain."""
    k = e.shape[0]

    def ring_eval(x):
        return Field2n(x.astype(np.float64)).to_eval()

    ee = [ring_eval(e[i]) for i in range(k)]
    rr = [ring_eval(r[i]) for i in range(k)]
    za = Field2n(np.zeros(n), EVAL)
    va, vb, vd = za, za, za
    for i in range(k):
        va = va + ee[i] * ee[i].transpose()
        vb = vb + rr[i] * ee[i].transpose()
        vd = vd + rr[i] * rr[i].transpose()

    factor = -s * s * sigma * sigma / (s * s - sigma * sigma)
    a = (factor * va).to_coeff() + s * s
    b = (factor * vb).to_coeff()
    d = (factor * vd).to_coeff() + s * s
    a, b, d = a.to_eval(), b.to_eval(), d.to_eval()

    sigma_large = np.sqrt(s * s - sigma * sigma)
    p2 = karney(rng, 0.0, sigma_large, n * k).reshape(k, n)

    # Tp2 = [sum e_i * p2_i ; sum r_i * p2_i] in the ring (trapdoor.cpp:
    # 208-218), then centers c = -sigma^2/(s^2 - sigma^2) * Tp2
    tp0, tp1 = za, za
    for i in range(k):
        pe = ring_eval(p2[i])
        tp0 = tp0 + ee[i] * pe
        tp1 = tp1 + rr[i] * pe
    cf = -sigma * sigma / (s * s - sigma * sigma)
    c0 = (cf * tp0).to_coeff()
    c1 = (cf * tp1).to_coeff()
    # imaginary parts are FFT roundoff only
    c0 = Field2n(c0.v.real, COEFF)
    c1 = Field2n(c1.v.real, COEFF)

    p1 = zsample_sigma_2x2(a, b, d, (c0, c1), rng).reshape(2, n)
    return np.concatenate([p1, p2], axis=0)
