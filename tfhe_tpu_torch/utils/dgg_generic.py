"""Arbitrary-center discrete Gaussian samplers (generic + Karney).

Port of `tfhe_tpu/utils/dgg_generic.py`: the same numpy host code, which
reads its generator's uniform stream in the same order and so draws the
same samples on the same seed (tests/test_torch_lattice.py).

TPU-native re-design of the reference's generic sampler stack
(`src/core/lib/math/discretegaussiangeneratorgeneric.cpp:59-345`,
`src/core/include/math/discretegaussiangeneratorgeneric.h:104-366`) and of
Karney's exact method (`discretegaussiangenerator.cpp:322-375`). The scalar
C++ walks one random bit at a time through DDG trees; here every stage is a
batch-vectorized numpy computation (gathered CDF inversion, masked rejection
sweeps), because the consumers — trapdoor/GPV preimage sampling and
parameter-dependent noise — want whole polynomials of samples per call, not
one integer.

Three layers, mirroring the reference's structure:

- ``BaseSampler``: fixed (fractional-center, sigma_b) sampler by Peikert CDF
  inversion (base-sampler role of ``BaseSampler::GenerateIntegerPeikert``,
  discretegaussiangeneratorgeneric.cpp:233-249). A whole batch inverts in one
  ``searchsorted``-style gather. The Knuth-Yao DDG tree variant is
  deliberately not replicated: its only advantage over inversion is
  bit-economy on serial hardware, and its bit-serial tree walk is the exact
  shape that cannot batch.
- ``GenericSampler``: the UCSD SampleZ/SampleC convolution sampler
  (https://eprint.iacr.org/2017/259, discretegaussiangeneratorgeneric.cpp:
  261-345) — any (center, sigma) with one precomputation: 2^b base samplers
  at centers i/2^b, a wide sampler built by ``SamplerCombiner`` doubling
  levels, Bernoulli flip-and-round on the center bits, then k rounds of
  digit-wise recentering. All rounds operate on the full batch at once.
- ``karney``: Karney's rejection method (algorithm D of arXiv:1303.6257,
  discretegaussiangenerator.cpp:322-375). The reference's bit-exact Bernoulli
  gadgets (AlgorithmB/G/P) exist to avoid floating point entirely; this
  implementation evaluates the same acceptance probabilities in double
  precision (exp is correctly rounded to ~1 ulp), which perturbs the
  distribution by < 2^-50 per sample — far below the 2^-40 statistical
  distance budget lattice parameters assume — and lets the rejection loop
  run as masked vector sweeps.

The smoothing-parameter constraint from the reference's header
(sigma_b >= 4*sqrt(2)*eta, discretegaussiangeneratorgeneric.h:92-95) is
enforced at construction.
"""

from __future__ import annotations

import numpy as np

_PRECISION = 53       # center bits (double mantissa), ckpp:56
_FLIPS = 23           # Bernoulli-approximated low bits, cpp:57
_TAIL_ACC = 1e-17     # per-point tail mass cut for CDF tables, cpp:61


class BaseSampler:
    """Fixed-center fixed-sigma integer Gaussian, batch CDF inversion.

    center may be any real; the integer part is re-added after sampling
    around the fractional part (discretegaussiangeneratorgeneric.cpp:59-73).
    """

    def __init__(self, center: float, sigma: float):
        self.sigma = float(sigma)
        c_int = np.floor(center) if center >= 0 else np.ceil(center)
        self.c_int = int(c_int)
        frac = float(center) - self.c_int
        self.fin = int(np.ceil(sigma * np.sqrt(-2.0 * np.log(_TAIL_ACC))))
        xs = np.arange(-self.fin, self.fin + 1, dtype=np.float64)
        p = np.exp(-((xs - frac) ** 2) / (2.0 * sigma * sigma))
        p /= p.sum()
        self.cdf = np.cumsum(p)

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        u = rng.random(size)
        idx = np.searchsorted(self.cdf, u, side="right")
        return idx - self.fin + self.c_int


def _combined_sample(tables: np.ndarray, fin: int,
                     centers: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Per-row CDF inversion: row i inverts ``tables[centers[i]]``.

    tables: [2^b, 2*fin+1] cumulative tables; centers: [M] int; u: [M]."""
    rows = tables[centers]                               # [M, 2*fin+1]
    idx = (rows < u[:, None]).sum(axis=1)
    return idx.astype(np.int64) - fin


class GenericSampler:
    """UCSD convolution sampler: any (center, sigma) from one precompute.

    Parameters mirror ``DiscreteGaussianGeneratorGeneric``'s ctor
    (discretegaussiangeneratorgeneric.cpp:261-291): ``sigma_b`` the base
    sampler deviation, ``log_base`` = b (2^b fractional centers), ``eta``
    the smoothing parameter, ``levels`` the SampleI doubling depth
    (MAX_LEVELS = 4, .h:104).
    """

    def __init__(self, sigma_b: float = 34.0, log_base: int = 7,
                 eta: float = 6.0, levels: int = 4):
        if sigma_b < 4.0 * np.sqrt(2.0) * eta:
            raise ValueError(
                f"base sigma {sigma_b} violates the smoothing bound "
                f">= 4*sqrt(2)*eta = {4 * np.sqrt(2) * eta:.2f} "
                "(discretegaussiangeneratorgeneric.h:92-95)")
        self.sigma_b = float(sigma_b)
        self.log_base = int(log_base)
        self.mask = (1 << log_base) - 1
        nbase = 1 << log_base

        # 2^b base CDF tables at centers i/2^b (cpp:261-266 builds the
        # BaseSampler array; here one [2^b, 2*fin+1] matrix)
        self.fin = int(np.ceil(sigma_b * np.sqrt(-2.0 * np.log(_TAIL_ACC))))
        xs = np.arange(-self.fin, self.fin + 1, dtype=np.float64)
        cs = np.arange(nbase, dtype=np.float64)[:, None] / nbase
        p = np.exp(-((xs[None, :] - cs) ** 2) / (2.0 * sigma_b * sigma_b))
        p /= p.sum(axis=1, keepdims=True)
        self.tables = np.cumsum(p, axis=1)

        # SampleI wide-sampler combiner coefficients (cpp:268-277)
        self.combiner = []
        wide_var = sigma_b * sigma_b
        for _ in range(1, levels):
            x1 = int(np.floor(np.sqrt(wide_var / (2.0 * eta * eta))))
            x2 = max(x1 - 1, 1)
            self.combiner.append((x1, x2))
            wide_var = (x1 * x1 + x2 * x2) * wide_var
        self.wide_var = wide_var

        # SampleC recentering depth + residual variance (cpp:279-290)
        self.k = int(np.ceil((_PRECISION - _FLIPS) / log_base))
        t = 1.0 / (1 << (2 * log_base))
        self.sampler_var = sigma_b * sigma_b * float(
            sum(t ** i for i in range(self.k)))
        self.min_sigma = float(np.sqrt(self.sampler_var))

    # -- internals ---------------------------------------------------------

    def _base0(self, rng, size):
        u = rng.random(size)
        idx = (self.tables[0] < u[:, None]).sum(axis=1)
        return idx.astype(np.int64) - self.fin

    def _wide_iter(self, rng, size):
        """SampleI wide sampler: combiner tree with two independent child
        draws per level (the reference combines a sampler with itself — two
        sequential GenerateInteger() calls — cpp:286-294); level l therefore
        consumes 2^l independent base batches."""
        def level(i, m):
            if i == 0:
                return self._base0(rng, m)
            x1, x2 = self.combiner[i - 1]
            return x1 * level(i - 1, m) + x2 * level(i - 1, m)
        return level(len(self.combiner), size)

    def _flip_and_round(self, rng, frac):
        """Round the 53-bit fractional centers to 30-bit using Bernoulli
        flips on the low 23 bits (cpp:314-328): the first random bit that
        differs from the center bit decides the rounding direction."""
        c = (frac * (1 << _PRECISION)).astype(np.int64)
        base_c = c >> _FLIPS
        bits = ((c[:, None] >> np.arange(_FLIPS - 1, -1, -1)) & 1)  # [M, 23]
        rb = rng.integers(0, 2, bits.shape, dtype=np.int64)
        diff = rb - bits
        nz = diff != 0
        first = np.argmax(nz, axis=1)
        has = nz.any(axis=1)
        d = diff[np.arange(len(c)), first]
        # rb > bit -> round down (keep base_c); rb < bit -> base_c + 1;
        # all equal -> base_c + 1 (cpp:320-327)
        up = np.where(has, (d < 0).astype(np.int64), 1)
        return base_c + up

    def _sample_c(self, rng, c):
        """SampleC (cpp:331-345): k rounds of digit-conditioned base draws.
        The C++ trunc-divide plus the negative-digit correction compose to a
        floor shift, so ``(c >> b) + sample`` is the whole update."""
        for _ in range(self.k):
            digit = (c & self.mask).astype(np.intp)
            u = rng.random(len(c))
            s = _combined_sample(self.tables, self.fin, digit, u)
            c = (c >> self.log_base) + s
        return c

    # -- public ------------------------------------------------------------

    def sample(self, rng: np.random.Generator, center, sigma,
               size: int | None = None) -> np.ndarray:
        """SampleZ (cpp:300-312): batch of integers ~ D_{Z, sigma, center}.

        center/sigma may be scalars or [size] arrays (per-sample centers —
        the trapdoor perturbation use case)."""
        center = np.asarray(center, dtype=np.float64)
        sigma = np.asarray(sigma, dtype=np.float64)
        if size is None:
            size = max(center.size, sigma.size)
        center = np.broadcast_to(center, (size,))
        sigma = np.broadcast_to(sigma, (size,))
        var = sigma * sigma
        if np.any(var < self.sampler_var):
            raise ValueError(
                f"requested sigma below sampler floor {self.min_sigma:.3f} "
                "(raise sigma or shrink log_base)")
        x = self._wide_iter(rng, size)
        c = center + x * np.sqrt((var - self.sampler_var) / self.wide_var)
        ci = np.floor(c).astype(np.int64)
        frac = c - ci
        return ci + self._sample_c(rng, self._flip_and_round(rng, frac))


def karney(rng, center, sigma, size: int | None = None) -> np.ndarray:
    """Karney's method, batch-rejection form (algorithm D of
    arXiv:1303.6257; discretegaussiangenerator.cpp:322-375). Acceptance
    probabilities exp(-k(k-1)/2) and exp(-x(2k+x)/2) are evaluated in double
    precision instead of the reference's bit-exact Bernoulli gadgets
    (AlgorithmB/G/P) — see module docstring for the error budget.

    ``center`` may be a scalar or a [size] array (per-sample centers — the
    G-lattice digit-sampling use case). ``rng`` is anything exposing
    ``random(n) -> float64 in [0, 1)`` (np.random.Generator, or BinFHERng
    so the blake2xb engine's byte stream drives it too); the geometric,
    sign, and uniform-j draws are all derived from that one stream."""
    sigma = float(np.asarray(sigma))
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    center = np.asarray(center, dtype=np.float64)
    if size is None:
        size = center.size
    center = np.broadcast_to(center, (size,))
    jmax = int(np.ceil(sigma))
    out = np.empty(size, dtype=np.int64)
    pending = np.ones(size, dtype=bool)
    tiny = np.finfo(np.float64).tiny
    while pending.any():
        idx = np.flatnonzero(pending)
        m = len(idx)
        c = center[idx]
        # D1: k with P[k] = e^{-k/2}(1 - e^{-1/2}) (AlgorithmG), inverted
        # from one uniform: k = floor(ln u / -1/2)
        u = np.maximum(rng.random(m), tiny)
        k = np.floor(np.log(u) * -2.0).astype(np.int64)
        # D2: accept with e^{-k(k-1)/2} (AlgorithmP)
        ok = rng.random(m) < np.exp(-0.5 * k * (k - 1))
        # D3: sign
        s = np.where(rng.random(m) < 0.5, -1, 1)
        # D4
        di0 = sigma * k + s * c
        i0 = np.ceil(di0)
        x0 = (i0 - di0) / sigma
        j = np.minimum((rng.random(m) * jmax).astype(np.int64), jmax - 1)
        x = x0 + j / sigma
        # D5/D6
        ok &= (x < 1.0) & ~((x == 0.0) & (s < 0) & (k == 0))
        # D7: k+1 AlgorithmB trials == accept with e^{-x(2k+x)/2}
        ok &= rng.random(m) < np.exp(-0.5 * x * (2.0 * k + x))
        # D8
        out[idx[ok]] = (s * (i0 + j)).astype(np.int64)[ok]
        pending[idx[ok]] = False
    return out
