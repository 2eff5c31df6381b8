"""Security-driven parameter generation for the pke schemes.

Port of `tfhe_tpu/pke/parametergen.py`, line for line on the port's
`utils/stdlattice.py`.

The analogue of the reference's parameter-generation framework
(`src/pke/lib/schemebase/base-parametergeneration.cpp` plus the per-scheme
`bfvrns-parametergeneration.cpp`, `bgvrns-parametergeneration.cpp`,
`ckksrns-parametergeneration.cpp`): given (multiplicative depth, security
level, plaintext/scaling configuration), derive the moduli chain and the ring
dimension from the HE-standard table instead of trusting hand-picked values,
and reject explicit choices that violate the requested level.

The noise models are for THIS framework's scheme implementations (exact
CRT-NTT BFV tensor product, leveled BGV with per-level ModReduce, RNS-CKKS
with rescale), not transcriptions of the reference's HPS/BEHZ bounds — the
bound structure (per-level bit budget x depth + fresh/decrypt margin, then
FindRingDim over logQP) mirrors base-parametergeneration.cpp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..utils.stdlattice import (SecurityError, find_ring_dim, max_log_q,
                                validate_security)

__all__ = ["SecurityError", "DerivedParams", "derive_bfv", "derive_bgv",
           "derive_ckks"]

_RING_DIMS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


@dataclass(frozen=True)
class DerivedParams:
    """What parameter generation decided (attached to contexts for
    inspection; the reference prints the same facts from its CCParams)."""
    scheme: str
    ring_dim: int
    log_q: int                 # total bits of the ciphertext modulus chain
    log_p: int                 # hybrid key-switch special-modulus budget
    n_limbs: int
    limb_bits: tuple[int, ...]  # per-limb target sizes, chain order
    security_level: str

    @property
    def log_qp(self) -> int:
        return self.log_q + self.log_p


def _fit_ring_dim(security_level: str, ring_dim: int | None,
                  log_qp_of: "callable") -> int:
    """Pick the smallest standard ring dim N with log_qp_of(N) within the
    security table (logQP grows only logarithmically with N, so a single
    ascending scan converges); validate an explicit choice instead."""
    if ring_dim is not None:
        validate_security(security_level, ring_dim, log_qp_of(ring_dim))
        return ring_dim
    if security_level == "NotSet":
        raise ValueError("ring_dim must be given when security_level is "
                         "'NotSet' (nothing to derive it from)")
    for n in _RING_DIMS:
        if log_qp_of(n) <= max_log_q(security_level, n):
            return n
    raise SecurityError(
        f"no standard ring dimension supports logQP="
        f"{log_qp_of(_RING_DIMS[-1])} at {security_level}")


def derive_bfv(mult_depth: int, t: int, security_level: str = "128_classic",
               ring_dim: int | None = None, limb_bits: int = 54) -> DerivedParams:
    """BFV chain: decryption needs total noise < Q/(2t); the exact tensor
    product grows noise by a factor ~ 2*t*N per multiplication, so
    logQ ~ fresh-noise margin + log2(2t) + depth * log2(2*t*N)
    (the role bfvrns-parametergeneration.cpp's noise recursion plays)."""
    if mult_depth < 0:
        raise ValueError("mult_depth must be >= 0")

    def log_qp(N: int) -> int:
        per_level = 1 + t.bit_length() + int(math.log2(N))
        return 30 + t.bit_length() + mult_depth * per_level

    N = _fit_ring_dim(security_level, ring_dim, log_qp)
    bits = log_qp(N)
    n_limbs = max(1, -(-bits // limb_bits))
    return DerivedParams("BFV", N, n_limbs * limb_bits, 0, n_limbs,
                         (limb_bits,) * n_limbs, security_level)


def derive_bgv(mult_depth: int, t: int, security_level: str = "128_classic",
               ring_dim: int | None = None,
               limb_bits: int | None = None) -> DerivedParams:
    """BGV leveled chain: one limb dropped per multiplication (ModReduce), so
    L = depth + 1 limbs, each big enough to absorb one level's noise factor
    ~ t * N (bgvrns-parametergeneration.cpp's per-level scaling)."""
    if mult_depth < 0:
        raise ValueError("mult_depth must be >= 0")
    L = mult_depth + 1

    def pick_limb(N: int) -> int:
        if limb_bits is not None:
            return limb_bits
        return min(59, t.bit_length() + int(math.log2(N)) + 12)

    def log_qp(N: int) -> int:
        return L * pick_limb(N)

    N = _fit_ring_dim(security_level, ring_dim, log_qp)
    lb = pick_limb(N)
    return DerivedParams("BGV", N, L * lb, 0, L, (lb,) * L, security_level)


def derive_ckks(mult_depth: int, scale_bits: int = 40,
                first_mod_bits: int = 60,
                security_level: str = "128_classic",
                ring_dim: int | None = None,
                key_switch: str = "bv") -> DerivedParams:
    """CKKS chain: firstModSize + depth x scalingModSize, exactly the
    ckksrns-parametergeneration.cpp composition; with hybrid key switching
    the special modulus P (~ one wide limb) is counted in logQP for the
    security lookup, as the reference does for HYBRID."""
    if mult_depth < 0:
        raise ValueError("mult_depth must be >= 0")
    if scale_bits >= first_mod_bits:
        raise ValueError("first_mod_bits must exceed scale_bits "
                         "(decryption precision headroom)")
    pattern = (first_mod_bits,) + (scale_bits,) * mult_depth
    log_q = sum(pattern)
    log_p = first_mod_bits if key_switch == "hybrid" else 0

    N = _fit_ring_dim(security_level, ring_dim, lambda n: log_q + log_p)
    return DerivedParams("CKKS", N, log_q, log_p, len(pattern), pattern,
                         security_level)
