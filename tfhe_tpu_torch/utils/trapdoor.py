"""Ring lattice trapdoors + GPV preimage sampling (Micciancio-Peikert 2012).

Port of `tfhe_tpu/utils/trapdoor.py`: the same numpy host code, on the
port's `ref/ntt.py` and `utils/rng.py`; the same trapdoors and preimages
on the same seed (tests/test_torch_lattice.py).

Counterpart of the reference's `src/core/lib/lattice/trapdoor.cpp`
(`RLWETrapdoorUtility::TrapdoorGen` / `GaussSamp`, trapdoor.h:106-198) and
the G-lattice sampler in `dgsampling.cpp` — functionality OpenFHE carries for
GPV signatures / identity-based encryption / obfuscation. It is off the
binfhe critical path, so this is a compact exact-arithmetic version:

- `trapdoor_gen`: A = [1, a, g_0 - (a r_0 + e_0), ..., g_{k-1} - (...)] over
  R_Q = Z_Q[X]/(X^N+1), trapdoor (r, e) short Gaussian;
- `gauss_samp`: given a syndrome u, samples short x with <A, x> = u mod Q by
  Gaussian perturbation + randomized digit (G-lattice) sampling, exactly the
  MP12 `x = p + [e z; r z; z]` composition the reference implements
  (trapdoor.cpp GaussSamp).

The perturbation uses the reference's exact 2x2 Schur-complement Fourier
sampler (ZSampleSigmaP -> utils/dgsampling.sample_pz) and the G-lattice
sampling uses the exact arbitrary-modulus sampler of eprint 2017/308
(GaussSampGq -> utils/dgsampling.gauss_samp_gq); the <A, x> = u identity is
verified exactly in tests. Pass ``spherical=True`` to gauss_samp for the
cheaper spherical-perturbation variant.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ref import ntt as ref_ntt
from .rng import BinFHERng


def _ring_mul(a: np.ndarray, b: np.ndarray, Q: int) -> np.ndarray:
    return ref_ntt.negacyclic_convolve(a % np.uint64(Q), b % np.uint64(Q), Q)


def _to_res(v: np.ndarray, Q: int) -> np.ndarray:
    return (np.asarray(v, dtype=np.int64) % np.int64(Q)).astype(np.uint64)


@dataclass
class RingTrapdoor:
    """Public row A [k+2, N] mod Q with secret short (r, e) [k, N] signed."""
    A: np.ndarray
    r: np.ndarray
    e: np.ndarray
    N: int
    Q: int
    base: int

    @property
    def k(self) -> int:
        return self.r.shape[0]


def trapdoor_gen(rng: BinFHERng, N: int, Q: int, base: int = 2,
                 sigma: float = 3.19) -> RingTrapdoor:
    """MP12 ring trapdoor (TrapdoorGen, trapdoor.cpp)."""
    k = int(np.ceil(np.log(Q) / np.log(base)))   # ceil(log_base Q)
    a = rng.discrete_uniform(N, Q)
    r = np.stack([rng.discrete_gaussian_signed(N, sigma) for _ in range(k)])
    e = np.stack([rng.discrete_gaussian_signed(N, sigma) for _ in range(k)])
    A = np.zeros((k + 2, N), dtype=np.uint64)
    A[0, 0] = 1                                  # the ring element 1
    A[1] = a
    for i in range(k):
        g_i = np.zeros(N, dtype=np.int64)
        g_i[0] = pow(base, i, Q)
        ar = _ring_mul(a, _to_res(r[i], Q), Q)
        A[2 + i] = _to_res(g_i - ar.astype(np.int64) - e[i], Q)
    return RingTrapdoor(A=A, r=r, e=e, N=N, Q=Q, base=base)


def _g_sample(rng: BinFHERng, v: np.ndarray, Q: int, base: int, k: int,
              sigma_g: float) -> np.ndarray:
    """Randomized G-lattice sampling: short z [k, N] with sum_i base^i z_i = v
    (mod Q) — the digit-randomized sampler of dgsampling.cpp, per coefficient.

    Each digit is drawn EXACTLY from the discrete Gaussian over its coset:
    cand ~ D_{d + base*Z, base*sigma_g}, realized as cand = d - base*y with
    y ~ D_{Z, sigma_g, d/base} via the arbitrary-center Karney sampler
    (utils/dgg_generic.py; both RNG engines drive it through the shared
    uniform stream). The subtracted multiple of base carries into the next
    digit, so the telescoped sum stays exactly v."""
    from .dgg_generic import karney

    digits = np.zeros((k, v.shape[-1]), dtype=np.int64)
    rem = np.asarray(v, dtype=object).copy()
    for i in range(k):
        digits[i] = np.array([int(x) % base for x in rem], dtype=np.int64)
        rem = np.array([int(x) // base for x in rem], dtype=object)
    z = np.zeros_like(digits)
    carry = np.zeros(v.shape[-1], dtype=np.int64)
    for i in range(k):
        d = digits[i] + carry
        y = karney(rng, d / base, sigma_g)
        cand = d - base * y
        carry = y
        z[i] = cand
    # fold the final carry back so sum_i base^i z_i == v exactly as integers
    z[k - 1] += base * carry
    return z


def gauss_samp(rng: BinFHERng, td: RingTrapdoor, u: np.ndarray,
               sigma_p: float = 60.0, sigma_g: float = 3.19,
               spherical: bool = False) -> np.ndarray:
    """Short preimage x [k+2, N] with <A, x> = u (mod Q) (GaussSamp,
    trapdoor.cpp:40-87): exact Schur-complement perturbation (sample_pz)
    + exact arbitrary-modulus G-lattice sampling (gauss_samp_gq), composed
    as x = p + [e z; r z; z]."""
    from .dgsampling import SIGMA, gauss_samp_gq, sample_pz, spectral_bound

    N, Q, k, base = td.N, td.Q, td.k, td.base
    # 1. perturbation p
    if spherical:
        p = np.stack([rng.discrete_gaussian_signed(N, sigma_p)
                      for _ in range(k + 2)])
    else:
        s = spectral_bound(N, k, base)
        p = sample_pz(N, s, (base + 1) * SIGMA, td.e, td.r, Q, rng)
    # 2. v = u - <A, p> mod Q
    ap = np.zeros(N, dtype=np.uint64)
    for i in range(k + 2):
        ap = (ap + _ring_mul(td.A[i], _to_res(p[i], Q), Q)) % np.uint64(Q)
    v = (_to_res(u, Q) + np.uint64(Q) - ap) % np.uint64(Q)
    # 3. G-lattice sample z with G z = v (mod Q)
    if spherical:
        z = _g_sample(rng, v, Q, base, k, sigma_g)
    else:
        z = gauss_samp_gq(v, (base + 1) * SIGMA, k, Q, base, rng)
    # 4. x = p + [<e, z>, <r, z>, z]
    half = Q // 2

    def center(w):
        w = np.asarray(w, dtype=np.int64) % Q
        return np.where(w > half, w - Q, w)

    ez = np.zeros(N, dtype=np.int64)
    rz = np.zeros(N, dtype=np.int64)
    for i in range(k):
        ez += center(_ring_mul(_to_res(td.e[i], Q), _to_res(z[i], Q), Q))
        rz += center(_ring_mul(_to_res(td.r[i], Q), _to_res(z[i], Q), Q))

    x = np.zeros((k + 2, N), dtype=np.int64)
    x[0] = p[0] + ez
    x[1] = p[1] + rz
    x[2:] = p[2:] + z
    return x


def apply_A(td: RingTrapdoor, x: np.ndarray) -> np.ndarray:
    """<A, x> mod Q for a signed preimage x."""
    Q = td.Q
    acc = np.zeros(td.N, dtype=np.uint64)
    for i in range(td.k + 2):
        acc = (acc + _ring_mul(td.A[i], _to_res(x[i], Q), Q)) % np.uint64(Q)
    return acc
