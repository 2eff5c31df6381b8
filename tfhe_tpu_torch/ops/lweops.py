"""Batched LWE linear algebra on the host: ciphertext x plaintext-matrix
products.

A copy of the host function of `tfhe_tpu/ops/lweops.py`, the exact
equivalent of `GPULWEOperation::CiphertextMulMatrix_CUDA`
(`src/binfhe/lib/lwe-operation.cu:50-141`): for K input ciphertexts and a
[K, M] int64 matrix, the M output ciphertexts
out_j = sum_k matrix[k][j] * ct_k (componentwise), mod `modulus`, exact for
any modulus below 2^54 (9-bit limbs against pre-shifted matrix residues).
The device version is not ported yet (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import numpy as np

from .. import lwe


def ciphertext_mul_matrix(cts: lwe.LWECiphertext, matrix: np.ndarray,
                          modulus: int) -> lwe.LWECiphertext:
    """cts: batched ciphertext with a [K, n], b [K]; matrix: [K, M] integers
    (signed allowed). Returns batched ciphertext with a [M, n], b [M] mod
    `modulus`."""
    if cts.a.ndim != 2:
        raise ValueError("ciphertext_mul_matrix expects a batched ciphertext [K, n]")
    K, n = cts.a.shape
    matrix = np.asarray(matrix)
    if matrix.shape[0] != K:
        raise ValueError("number of matrix rows must equal the number of input ciphertexts")
    if modulus >= (1 << 54):
        raise ValueError("modulus must be < 2^54")
    mod = np.uint64(modulus)

    # components [K, n+1]: a columns then b (lwe-operation.cu:79-85)
    comp = np.concatenate([np.asarray(cts.a).astype(np.uint64) % mod,
                           (np.asarray(cts.b).astype(np.uint64) % mod)[:, None]], axis=1)
    w = (matrix.astype(object) % int(modulus)).astype(np.uint64)      # residues [K, M]

    limb_bits = 9
    n_limbs = (modulus.bit_length() + limb_bits - 1) // limb_bits
    mask = np.uint64((1 << limb_bits) - 1)

    # w_i = (w * 2^(9 i)) mod modulus; each doubling step stays < 2^63
    w_shifted = [w]
    for _ in range(n_limbs - 1):
        w_shifted.append((w_shifted[-1] << np.uint64(limb_bits)) % mod)

    out = np.zeros((matrix.shape[1], n + 1), dtype=np.uint64)
    k_chunk = max(1, (1 << 63) // int(modulus))  # keep the K-sum below 2^64
    k_chunk = min(k_chunk, max(1, (1 << 24) // (n + 1)))  # and temporaries bounded
    for i, wi in enumerate(w_shifted):
        limb = (comp >> np.uint64(limb_bits * i)) & mask              # [K, n+1]
        for s in range(0, K, k_chunk):
            e = min(K, s + k_chunk)
            # [Kc, n+1, 1] * [Kc, 1, M] -> reduce over K
            part = (limb[s:e, :, None] * wi[s:e, None, :]) % mod
            out += part.sum(axis=0).T
            out %= mod
    return lwe.LWECiphertext(out[:, :n].copy(), out[:, n].copy(), modulus)
