"""The port's CiphertextMulMatrix on a device (`ops/lweops.py:
ciphertext_mul_matrix_device`, here its CPU path: the same limb algorithm
on an int64 `torch.matmul`) against the JAX package's device product
(`tfhe_tpu.ops.lweops.ciphertext_mul_matrix_device`) and the host product,
element for element, on inputs made from a seed with numpy: moduli 2^35
(the GEMM example's), 2^35 + 3, a 54-bit odd modulus and 257; shapes below
the 16 rows and off the multiples of 8 that `torch._int_mm` needs (the
port pads them); signed matrices."""

import numpy as np
import pytest

from tfhe_tpu import lwe as jax_lwe
from tfhe_tpu.ops import lweops as jax_lweops
import tfhe_tpu_torch
from tfhe_tpu_torch import lwe
from tfhe_tpu_torch.ops import lweops
from torch_threads import one_torch_thread  # noqa: F401

MODULI = {"2^35": 1 << 35, "2^35+3": (1 << 35) + 3, "54-bit": (1 << 54) - 33, "257": 257}
SHAPES = [(5, 3, 7), (13, 33, 11), (40, 9, 24)]      # (K, n, M)


def inputs(modulus: int, K: int, n: int, M: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, modulus, (K, n), dtype=np.uint64)
    b = rng.integers(0, modulus, K, dtype=np.uint64)
    a[0, :2] = [0, modulus - 1]
    mat = rng.integers(-1000, 1001, (K, M))
    mat[0, 0], mat[-1, -1] = -(1 << 40), (1 << 40) - 1
    return a, b, mat


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "K%d-n%d-M%d" % s)
@pytest.mark.parametrize("modulus", MODULI.values(), ids=MODULI.keys())
def test_device_product_matches_jax_and_host(modulus, shape):
    K, n, M = shape
    a, b, mat = inputs(modulus, K, n, M, seed=K * M)
    got = lweops.ciphertext_mul_matrix_device(lwe.LWECiphertext(a, b, modulus), mat,
                                              modulus, "cpu")
    want = jax_lweops.ciphertext_mul_matrix_device(jax_lwe.LWECiphertext(a, b, modulus),
                                                   mat, modulus)
    host = lweops.ciphertext_mul_matrix(lwe.LWECiphertext(a, b, modulus), mat, modulus)
    assert got.modulus == modulus and got.a.shape == (M, n) and got.b.shape == (M,)
    for x in (want, host):
        assert np.array_equal(got.a, np.asarray(x.a, dtype=np.uint64))
        assert np.array_equal(got.b, np.asarray(x.b, dtype=np.uint64))
    j = M - 1
    assert int(got.b[j]) == sum(int(mat[k, j]) * int(b[k]) for k in range(K)) % modulus
    assert int(got.a[j, 0]) == sum(int(mat[k, j]) * int(a[k, 0]) for k in range(K)) % modulus


def test_context_runs_the_product_on_its_device():
    """The port's context needs no keys for the product: the device
    version on the context's device, the host one under the oracle."""
    mod = 1 << 35
    a, b, mat = inputs(mod, 6, 10, 4, seed=3)
    cts = lwe.LWECiphertext(a, b, mod)
    cc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    got = cc.ciphertext_mul_matrix(cts, mat, mod)
    want = lweops.ciphertext_mul_matrix(cts, mat, mod)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
