"""Randomness for key generation and encryption (host side).

Replaces the reference's Blake2XB-seeded generators
(`src/core/include/utils/prng/blake2engine.h`,
`src/core/lib/math/discretegaussiangenerator.cpp`,
`ternaryuniformgenerator.cpp`, `discreteuniformgenerator.cpp`).

Two engines:

- ``engine="pcg64"`` (default): numpy PCG64. Parity with OpenFHE is defined
  as "same keys -> bit-identical homomorphic evaluation", not "same seed ->
  identical ciphertexts" (the reference itself never relies on cross-library
  RNG parity).
- ``engine="blake2xb"``: the reference's own PRNG byte stream, bit-exact
  (utils/blake2.py, validated against blake2xb-ref.c golden vectors), for
  keygen-parity configurations. The u32 stream matches `Blake2Engine`
  word for word; the distribution layers on top consume that stream with
  documented (not libstdc++-identical) algorithms.

The distributions match the reference semantically:

- ``discrete_gaussian``: integer Gaussian with std sigma (3.19), sampled by
  exact CDF inversion over a +-ceil(10*sigma) support (beyond the reference's
  Peikert-table tail; per-sample probability mass outside is < 2^-140).
- ``discrete_uniform``: uniform over [0, modulus) (mask-and-reject, unbiased).
- ``ternary_uniform``: uniform over {-1, 0, 1}, returned as residues mod
  modulus like `TernaryUniformGeneratorImpl::GenerateVector`.
"""

from __future__ import annotations

import numpy as np

# Buckets of [0, 1) in the discrete Gaussian's index: a power of two, so
# that u * _DGG_BUCKETS is exact and its floor the bucket of u.
_DGG_BUCKETS = 1 << 16


class BinFHERng:
    """All randomness used by keygen/encryption, seeded once."""

    def __init__(self, seed: int | None = None, engine: str = "pcg64"):
        self.engine = engine
        if engine == "blake2xb":
            from .blake2 import Blake2XbEngine
            if seed is None:
                # entropy-seed like the reference's PRNG (blake2engine.h seeds
                # from std::random_device); a fixed default would silently
                # reproduce identical keys across runs.
                import os
                seed = np.frombuffer(os.urandom(64), dtype=np.uint32)
            self._b2 = Blake2XbEngine(seed)
            self._rng = None
        elif engine == "pcg64":
            self._b2 = None
            self._rng = np.random.default_rng(seed)
        else:
            raise ValueError(f"unknown rng engine {engine!r}")
        self._dgg_tables: dict[float, tuple[np.ndarray, np.ndarray]] = {}

    # -- engine primitives -------------------------------------------------

    def random(self, size: int) -> np.ndarray:
        """Public uniform-[0,1) stream (the interface utils/dgg_generic.py's
        Karney sampler consumes, so either engine can drive it)."""
        return self._uniform01(size)

    def _uniform01(self, size: int) -> np.ndarray:
        """float64 uniforms in [0, 1) with 53 random bits."""
        if self._rng is not None:
            return self._rng.random(size)
        w = self._b2.next_u32(2 * size).astype(np.uint64)
        u64 = w[0::2] | (w[1::2] << np.uint64(32))
        return (u64 >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)

    def _uniform_below(self, size: int, bound: int) -> np.ndarray:
        """Unbiased uniforms in [0, bound) as uint64 (bound <= 2^64)."""
        if self._rng is not None:
            return self._rng.integers(0, bound, size=size, dtype=np.uint64)
        bits = max(1, int(bound - 1).bit_length())
        words = (bits + 31) // 32
        mask = np.uint64((1 << bits) - 1)
        out = np.empty(size, dtype=np.uint64)
        filled = 0
        while filled < size:
            k = size - filled
            draw = self._b2.next_u32(k * words).astype(np.uint64).reshape(k, words)
            v = draw[:, 0]
            for w in range(1, words):
                v = v | (draw[:, w] << np.uint64(32 * w))
            v = v & mask
            good = v[v < np.uint64(bound)]
            out[filled:filled + len(good)] = good
            filled += len(good)
        return out

    # -- distributions -----------------------------------------------------

    def _dgg_table(self, sigma: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(values, their CDF, bucket index): bucket b of _DGG_BUCKETS equal
        slices of [0, 1) holds the value index of every u in it when the
        CDF has no step inside, else -1."""
        if sigma not in self._dgg_tables:
            tail = int(np.ceil(10 * sigma))
            xs = np.arange(-tail, tail + 1)
            # exact-enough CDF in float64; probabilities below ~1e-300 underflow to 0,
            # which only truncates a tail that is unreachable anyway.
            logp = -(xs.astype(np.float64) ** 2) / (2.0 * sigma * sigma)
            p = np.exp(logp - logp.max())
            cdf = np.cumsum(p)
            cdf /= cdf[-1]
            # the index searchsorted gives u is monotone in u: equal at a
            # bucket's first and last float, it is that of every u between
            edges = np.arange(_DGG_BUCKETS + 1, dtype=np.float64) / _DGG_BUCKETS
            first = np.searchsorted(cdf, edges[:-1], side="right")
            last = np.searchsorted(cdf, np.nextafter(edges[1:], 0.0), side="right")
            bucket = np.minimum(first, len(xs) - 1).astype(np.int32)
            bucket[first != last] = -1
            self._dgg_tables[sigma] = (xs, cdf, bucket)
        return self._dgg_tables[sigma]

    def discrete_gaussian(self, size: int, sigma: float, modulus: int) -> np.ndarray:
        """Integer Gaussian errors as residues mod `modulus` (object dtype if large)."""
        xs, idx = self._dgg_draw(size, sigma)
        if modulus < (1 << 63):
            return _to_residues(xs, modulus)[idx]
        return _to_residues(xs[idx], modulus)

    def discrete_gaussian_signed(self, size: int, sigma: float) -> np.ndarray:
        xs, idx = self._dgg_draw(size, sigma)
        return xs[idx]

    def _dgg_draw(self, size: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
        """(values, indices): the draw is values[searchsorted(cdf, u,
        "right")] for uniform u (the last value for u beyond the CDF's
        rounding), read from the bucket index where a bucket holds one
        value."""
        xs, cdf, bucket = self._dgg_table(sigma)
        u = self._uniform01(size)
        # exact: the bucket count is a power of two and u * count < 2^16
        idx = bucket[(u * _DGG_BUCKETS).astype(np.uint16)]
        step = np.nonzero(idx < 0)[0]
        idx[step] = np.minimum(np.searchsorted(cdf, u[step], side="right"), len(xs) - 1)
        return xs, idx

    def flooding_gaussian_signed(self, size: int, sigma: float) -> np.ndarray:
        """Rounded continuous Gaussian for LARGE flooding sigmas (threshold
        decryption's MP_SD = 2^20 etc.) — the CDF-inversion table of
        discrete_gaussian_signed would need ~12*sigma entries there. Drawn
        from the context's own uniform stream (Box-Muller), so seeding stays
        deterministic."""
        u1 = np.clip(self._uniform01(size), 1e-300, None)
        u2 = self._uniform01(size)
        g = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        return np.rint(g * sigma).astype(np.int64)

    def discrete_uniform(self, size: int, modulus: int,
                         dtype=np.uint64) -> np.ndarray:
        """Uniform residues in [0, modulus). `dtype` narrows the OUTPUT
        storage (the draw itself is unbiased either way) — at key-switch-key
        scale (~10^8 entries) a u16 result avoids a transient GB of u64."""
        if modulus <= (1 << 63):
            if self._rng is not None and modulus <= int(np.iinfo(dtype).max) + 1:
                if modulus & (modulus - 1) == 0:
                    # power-of-two bound: full-width word draw + mask (no
                    # rejection/Lemire loop — 2x faster at the 10^8-draw
                    # key-switch-key scale, where the accelerated sets'
                    # qKS = 2^35 A block is ~5 GB of u64)
                    # a full-range u64 draw is the bit generator's raw word
                    raw = (self._rng.bit_generator.random_raw(size) if dtype == np.uint64
                           else self._rng.integers(0, int(np.iinfo(dtype).max) + 1,
                                                   size=size, dtype=dtype))
                    if modulus - 1 != int(np.iinfo(dtype).max):
                        raw &= dtype(modulus - 1)
                    return raw
                if dtype != np.uint64:
                    return self._rng.integers(0, modulus, size=size, dtype=dtype)
            out = self._uniform_below(size, modulus)
            return out if dtype == np.uint64 else out.astype(dtype)
        # arbitrary-width rejection-free sampling via 128-bit assembly
        if self._rng is not None:
            hi = self._rng.integers(0, 1 << 32, size=size, dtype=np.uint64)
            lo = self._rng.integers(0, 1 << 64, size=size, dtype=np.uint64)
        else:
            w = self._b2.next_u32(3 * size).astype(np.uint64)
            hi = w[0::3]
            lo = w[1::3] | (w[2::3] << np.uint64(32))
        out = np.empty(size, dtype=object)
        for i in range(size):
            out[i] = ((int(hi[i]) << 64) | int(lo[i])) % modulus
        return out

    def ternary_uniform_signed(self, size: int,
                               hamming_weight: int | None = None
                               ) -> np.ndarray:
        """Ternary secret in {-1, 0, 1} (stored signed; embed mod m on
        demand). With `hamming_weight` h, exactly h coordinates are nonzero
        (+-1 uniformly) — the reference's sparse variant
        (ternaryuniformgenerator.h GenerateVector(size, modulus, h);
        SPARSE_TERNARY uses h = 64, base-pke.cpp:67-70)."""
        if hamming_weight is None:
            if self._rng is not None:
                return self._rng.integers(-1, 2, size=size).astype(np.int64)
            return self._uniform_below(size, 3).astype(np.int64) - 1
        h = int(hamming_weight)
        if not 0 < h <= size:
            raise ValueError(f"hamming weight {h} not in (0, {size}]")
        out = np.zeros(size, dtype=np.int64)
        # engine-deterministic support selection: order positions by an
        # engine uniform draw, take the first h
        if self._rng is not None:
            pos = self._rng.permutation(size)[:h]
            signs = self._rng.integers(0, 2, size=h) * 2 - 1
        else:
            pos = np.argsort(self.random(size))[:h]
            signs = self._uniform_below(h, 2).astype(np.int64) * 2 - 1
        out[pos] = signs
        return out


def _to_residues(signed_vals: np.ndarray, modulus: int) -> np.ndarray:
    """Map signed integers to residues in [0, modulus)."""
    if modulus < (1 << 63):
        m = np.int64(modulus)
        v = signed_vals.astype(np.int64) % m
        return v.astype(np.uint64)
    out = np.empty(len(signed_vals), dtype=object)
    for i, v in enumerate(signed_vals):
        out[i] = int(v) % modulus
    return out
