"""Batched LWE linear algebra: ciphertext x plaintext-matrix products.

Port of `tfhe_tpu/ops/lweops.py`, the exact equivalent of
`GPULWEOperation::CiphertextMulMatrix_CUDA`
(`src/binfhe/lib/lwe-operation.cu:50-141`): for K input ciphertexts and a
[K, M] int64 matrix, the M output ciphertexts
out_j = sum_k matrix[k][j] * ct_k (componentwise), mod `modulus`, exact for
any modulus below 2^54. `ciphertext_mul_matrix` is the host copy (9-bit
limbs against pre-shifted matrix residues); `ciphertext_mul_matrix_device`
the device one (7-bit int8 limbs, one integer matrix product for every limb
pair, recombined with exact 64-bit Shoup products), where the reference
computes in float64 through cuBLAS, exact only while every inner product
stays below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import lwe
from .modmath import mulmod_shoup64, shoup64

_LIMB_BITS = 7
_LIMB_MASK = (1 << _LIMB_BITS) - 1


def _n_limbs(modulus: int) -> int:
    return (int(modulus - 1).bit_length() + _LIMB_BITS - 1) // _LIMB_BITS


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _limbs(x: torch.Tensor, n_limbs: int, rows: int, cols: int) -> torch.Tensor:
    """Residues x [r, c] int64 (< 2^54) -> their 7-bit limbs as int8
    [n_limbs * rows, cols], limb l in rows [l * rows, l * rows + r), the
    rest zero padding."""
    limbs = torch.stack([(x >> (_LIMB_BITS * l)) & _LIMB_MASK for l in range(n_limbs)])
    limbs = F.pad(limbs, (0, cols - x.shape[1], 0, rows - x.shape[0]))
    return limbs.to(torch.int8).reshape(n_limbs * rows, cols)


def _limb_products(wt: torch.Tensor, ct: torch.Tensor, k_chunk: int) -> torch.Tensor:
    """wt [Rw, K] and ct [Rc, K] int8 limbs -> the exact product wt ct^T
    [Rw, Rc] int64, K taken in chunks of k_chunk so each chunk's int32
    sums stay below 2^31. On CUDA each chunk is `torch._int_mm` (int8 x
    int8 -> int32 on the tensor cores) with both operands K-major, the
    layout cuBLASLt's int8 products take at every shape (with the second
    operand row-major it refused [120, 32] x [32, 200] on an H100);
    elsewhere an int64 `torch.matmul`, exact since K * 127^2 is far below
    2^63."""
    total = None
    for s in range(0, wt.shape[1], k_chunk):
        a, b = wt[:, s:s + k_chunk].contiguous(), ct[:, s:s + k_chunk].contiguous().t()
        if wt.device.type == "cuda":
            part = torch._int_mm(a, b).to(torch.int64)
        else:
            part = torch.matmul(a.to(torch.int64), b.to(torch.int64))
        total = part if total is None else total + part
    return total


def ciphertext_mul_matrix_device(cts: lwe.LWECiphertext, matrix: np.ndarray,
                                 modulus: int,
                                 device: str | torch.device = "cuda") -> lwe.LWECiphertext:
    """The product of `ciphertext_mul_matrix` on `device`, exact for any
    modulus < 2^54 (`tfhe_tpu/ops/lweops.py:ciphertext_mul_matrix_device`).
    The components [K, n+1] and the transposed matrix residues [M, K] are
    split into L 7-bit limbs on the device; one product of the stacked limbs
    [L*M, K] x [L*(n+1), K]^T gives every limb pair (j, i) at once; the pairs
    are summed by weight class s = i + j in int64 and recombined as
    sum_s (group_s mod m) * (2^(7s) mod m) mod m. The operands are padded
    with zeros to shapes that `torch._int_mm` takes on CUDA (more than 16
    rows, every width a multiple of 8), and the padding is cut off."""
    if cts.a.ndim != 2:
        raise ValueError("ciphertext_mul_matrix expects a batched ciphertext [K, n]")
    K, n = cts.a.shape
    matrix = np.asarray(matrix)
    if matrix.shape[0] != K:
        raise ValueError("number of matrix rows must equal the number of input ciphertexts")
    if modulus >= (1 << 54):
        raise ValueError("modulus must be < 2^54")
    mod = np.uint64(modulus)
    M, n1, L = matrix.shape[1], n + 1, _n_limbs(modulus)

    comp = np.concatenate([np.asarray(cts.a).astype(np.uint64) % mod,
                           (np.asarray(cts.b).astype(np.uint64) % mod)[:, None]], axis=1)
    comp = torch.from_numpy(comp.astype(np.int64)).to(device)
    w = torch.from_numpy(matrix.astype(np.int64)).to(device) % modulus  # residues [K, M]
    Kp, Mp, n1p = _up(K, 8), max(24, _up(M, 8)), _up(n1, 8)
    ct = _limbs(comp.t(), L, n1p, Kp)                                # [L*n1p, Kp]
    wt = _limbs(w.t(), L, Mp, Kp)                                    # [L*Mp, Kp]

    k_chunk = (1 << 31) // (_LIMB_MASK * _LIMB_MASK) // 8 * 8       # K_chunk * 127^2 < 2^31
    prod = _limb_products(wt, ct, k_chunk).reshape(L, Mp, L, n1p)    # [j, M, i, n1]
    out = None
    for s in range(2 * L - 1):
        group = sum(prod[j, :, s - j] for j in range(max(0, s - L + 1), min(L, s + 1)))
        w_s = pow(2, _LIMB_BITS * s, modulus)
        t = mulmod_shoup64(group % modulus, w_s,
                           int(shoup64(np.array([w_s], dtype=np.uint64), modulus)[0]),
                           modulus)
        out = t if out is None else (out + t) % modulus
    out = out[:M, :n1].cpu().numpy().astype(np.uint64)
    return lwe.LWECiphertext(out[:, :n].copy(), out[:, n].copy(), modulus)


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
