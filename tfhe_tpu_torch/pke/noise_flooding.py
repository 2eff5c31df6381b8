"""CKKS noise flooding for the IND-CPA^D setting (NOISE_FLOODING_DECRYPT).

Port of `tfhe_tpu/pke/noise_flooding.py`, the counterpart of the reference's
experimental enhanced-security CKKS mode (`ckksrns-pke.cpp:49-54` flooded
Decrypt, `gen-cryptocontext-ckksrns-internal.h:71-92` flooding sigma derivation,
`ckkspackedencoding.cpp:490-504` EXEC_NOISE_ESTIMATION decode, and the
two-phase protocol of `examples/ckks-noise-flooding.cpp`):

  Phase 1 (EXEC_NOISE_ESTIMATION): run the encrypted computation once on
  representative REAL-valued data and measure the noise of the result — for
  conjugation-free circuits the message lives in the real part of the
  decoded slots and the noise shows up symmetrically in the imaginary part,
  so log2(std(Im(slots))) in integer (pre-scale-division) units estimates
  the noise magnitude.

  Phase 2 (EXEC_EVALUATION + NOISE_FLOODING_DECRYPT): regenerate keys, run
  the same computation, and decrypt with Gaussian noise of
  sigma = 2^(statistical_security/2 + log2(sqrt(12*num_adversarial_queries))
            + noise_estimate)
  added to the raw decryption before decoding — "flooding" the decryption
  error so published results leak nothing about the secret key beyond the
  IND-CPA^D bound (Li-Micciancio countermeasure).
"""

from __future__ import annotations

import math

import numpy as np

from .ckks import CKKSCiphertext, CKKSContext, decode

__all__ = ["estimate_noise", "flooding_sigma", "decrypt_flooded"]


def _normalize(ct: CKKSCiphertext) -> CKKSCiphertext:
    """Spend any deferred rescale (noise degree 2 -> 1) so the noise is
    measured / flooded in deg-1 integer units — keeps the two phases on the
    same grid regardless of where the circuit left the ciphertext."""
    while ct.noise_deg > 1:
        from .ckks_rns import rescale_rns
        q_last = ct.polys[0].params.moduli[-1]
        ct = CKKSCiphertext([rescale_rns(p) for p in ct.polys],
                            ct.scale / q_last, ct.params,
                            noise_deg=ct.noise_deg - 1)
    return ct


def _raw_decrypt_coeffs(ctx: CKKSContext, sk, ct: CKKSCiphertext):
    """Centered big-int coefficients of c0 + c1*s + ... (no decode)."""
    lp = ct.level_params
    s = ctx._sk_at(sk, lp)
    acc = ct.polys[0]
    s_pow = s
    for c in ct.polys[1:]:
        acc = acc + c * s_pow
        s_pow = s_pow * s
    return acc.to_centered_bigint()


def estimate_noise(ctx: CKKSContext, sk, ct: CKKSCiphertext) -> float:
    """Phase-1 noise estimate: log2 of the standard deviation of the
    imaginary slot components in integer units (the reference's
    Plaintext::GetLogError under EXEC_NOISE_ESTIMATION,
    ckkspackedencoding.cpp:497-504). Valid for circuits over real-valued
    inputs with no conjugation, where Im(slots) is pure noise."""
    ct = _normalize(ct)
    coeffs = _raw_decrypt_coeffs(ctx, sk, ct)
    z = decode(ctx.params, coeffs, scale=1.0)          # integer-unit slots
    stddev = float(np.std(z.imag))
    if stddev <= 0.0:
        stddev = 0.125 * math.sqrt(ctx.params.N)       # floor, as decode does
    return math.log2(stddev)


def flooding_sigma(noise_estimate: float,
                   statistical_security: float = 30.0,
                   num_adversarial_queries: int = 1) -> float:
    """sigma = 2^(statSec/2 + log2(sqrt(12*queries)) + noiseEstimate)
    (gen-cryptocontext-ckksrns-internal.h:77-79; defaults 30 / 1 as in
    the reference's CCParams)."""
    logstd = statistical_security / 2.0 + math.log2(
        math.sqrt(12.0 * num_adversarial_queries))
    return 2.0 ** (logstd + noise_estimate)


def decrypt_flooded(ctx: CKKSContext, sk, ct: CKKSCiphertext,
                    noise_estimate: float,
                    statistical_security: float = 30.0,
                    num_adversarial_queries: int = 1,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Phase-2 decryption with noise flooding: add a fresh Gaussian of the
    derived sigma to the raw decryption, then decode (ckksrns-pke.cpp:49-54).

    The flooding sigma must leave >= 3 bits of precision under the scale
    (the reference's MAX_MODULUS_SIZE guard) — raise the scale / modulus
    chain if this throws."""
    ct = _normalize(ct)
    sigma = flooding_sigma(noise_estimate, statistical_security,
                           num_adversarial_queries)
    if sigma >= ct.scale / 8.0:
        raise ValueError(
            f"flooding sigma 2^{math.log2(sigma):.1f} leaves <3 bits of "
            f"precision under scale 2^{math.log2(ct.scale):.1f}; use larger "
            f"scale/moduli (the reference requires logstd + noiseEstimate "
            f"<= scalingModSize - 3)")
    if sigma >= 2.0 ** 52:
        raise ValueError("flooding sigma too large for float64 sampling")
    rng = rng or np.random.default_rng()
    coeffs = _raw_decrypt_coeffs(ctx, sk, ct)
    noise = np.rint(rng.normal(0.0, sigma, ctx.params.N)).astype(np.int64)
    flooded = [int(c) + int(e) for c, e in zip(coeffs, noise)]
    return decode(ctx.params, flooded, ct.scale)
