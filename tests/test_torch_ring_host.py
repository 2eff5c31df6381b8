"""The host side of the large rings, on the CPU.

- `ops/keygen.ring_mul`: the GINX bootstrapping key's ring products a * s
  computed in torch on a device (the CPU here), in place of the host
  engine's NTTs. From the same seed, `ref/rgsw.keygen_acc_cggi` with it and
  without it gives the same key, word for word, at each kind of modulus:
  a pair of primes (the accelerated RNS sets, at N = 2048 and 16384), one
  prime below 2^28 (logQ = 11), the single 54-bit prime and a two-limb
  classic set. The LWE secret is cut to a few coefficients (the rows are
  2 n d2 alike).
- The native engine's CGGI rotation (`native.cggi_rotate`): a batch smaller
  than the thread count at N >= 4096 shares each round's steps over the
  threads (the host oracle runs one row a call), a larger one runs a
  ciphertext a thread. Both equal the numpy oracle, `rgsw.add_to_acc_cggi`,
  round by round. The engine's OpenMP threads are torch's intra-op threads
  (one runtime), so that test runs on four.
"""

import numpy as np
import pytest
import torch

from tfhe_tpu_torch import native
from tfhe_tpu_torch.ops import keygen
from tfhe_tpu_torch.params import Method, ParamSet, RGSWParams, from_gpu_style, from_param_set
from tfhe_tpu_torch.ref import modmath, ntt, rgsw
from tfhe_tpu_torch.utils.rng import BinFHERng
from torch_threads import one_torch_thread  # noqa: F401

SETS = {
    "rns-N2048": lambda: from_gpu_style(ParamSet.TOY, False, 17, num_digits_to_throw=1),
    "rns-N16384": lambda: from_gpu_style(ParamSet.TOY, False, 17, N=16384,
                                         num_digits_to_throw=1),
    "logQ11": lambda: from_gpu_style(ParamSet.TOY, False, 11),
    "single-prime": lambda: from_gpu_style(ParamSet.TOY, False, 17, rns_modulus=False),
    "std128q": lambda: from_param_set(ParamSet.STD128Q),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_device_ring_products_equal_the_host_keygen(name):
    params = SETS[name]()
    rp, Q = params.rgsw, params.lwe.Q
    lwe_sk = np.array([1, -1, 0, 1, -1, 0], dtype=np.int64)
    keys = []
    for on_device in (False, True):
        rng = BinFHERng(20261019)
        s_coeff = modmath.asarray(rng.ternary_uniform_signed(rp.N), Q)
        ring_mul = keygen.ring_mul(s_coeff, Q, rp.rns_primes, "cpu") if on_device else None
        keys.append(rgsw.keygen_acc_cggi(rng, rp, ntt.forward(s_coeff, Q), lwe_sk, ring_mul))
    assert (rp.rns_primes is not None) == name.startswith("rns")
    assert keys[0].shape == (len(lwe_sk), 2, rp.digits_g2, 2, rp.N)
    assert np.array_equal(keys[0], keys[1])


@pytest.fixture
def four_threads():
    """Four OpenMP threads, so that 1 and 2 rows share a round's steps."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("N,Q,g_bits,digits,throw", [
    (4096, 133857281 * 133644289, 18, 3, 1),     # a pair of primes
    (4096, 18014398509309953, 27, 2, 1),         # the single 54-bit prime
    (8192, 133857281, 7, 4, 0),                  # a prime below 2^28
    (1024, 134215681, 7, 4, 0),                  # below N = 4096: a ciphertext a thread
], ids=["rns-N4096", "prime54-N4096", "logQ11-N8192", "N1024"])
def test_native_rotation_equals_the_numpy_oracle(four_threads, N, Q, g_bits, digits, throw):
    assert native.get_lib() is not None
    rng = np.random.default_rng(N + g_bits)
    n, d2 = 3, 2 * (digits - throw)
    bsk_hat = ntt.forward(rng.integers(0, Q, (n, 2, d2, 2, N)).astype(np.uint64), Q)
    p = RGSWParams(N=N, Q=Q, q=2 * N, base_g=1 << g_bits, base_r=23, method=Method.GINX,
                   std=3.19)
    p.num_digits_to_throw = throw
    for B in (1, 2, 9):
        acc = rng.integers(0, Q, (B, 2, N)).astype(np.uint64)
        a = rng.integers(0, 2 * N, (B, n)).astype(np.int64)
        a[0, :2] = [0, N]
        got = acc.copy()
        assert native.cggi_rotate(got, a, bsk_hat, Q, ntt._psi(N, Q), g_bits, digits - throw,
                                  throw)
        want = acc.copy()
        for b in range(B):
            for r in range(n):
                want[b] = rgsw.add_to_acc_cggi(p, bsk_hat[r, 0], bsk_hat[r, 1], int(a[b, r]),
                                               want[b])
        assert np.array_equal(got, want), B
