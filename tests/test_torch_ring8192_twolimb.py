"""Ring dimension N = 8192 at the reference's single 54-bit prime, on the CPU.

The accelerated TOY sets at N = 8192 with `rns_modulus=False`
(`from_gpu_style(TOY, ..., N=8192, rns_modulus=False)`: n = 32, qKS = 2^35,
one digit thrown, Q = ntt_prime(54, 16384) = 18014398508400641) take the
port's two-limb path, whose kernel is `csrc/blind_rotate64.cu` (a cluster
of four blocks at this ring). EvalSign (logQ 17, gadget bases 2^18 and
2^27) and EvalDecomp (logQ 23) on the sign context's keys, and EvalFunc
(logQ 12, arbFunc, base 2^27) on one LWE secret, ring secret and switching
key, run through the port's context with device "cpu" (the kernel's plain
version) on the JAX package's keys and ciphertexts, carried across with
`tfhe_tpu_torch.convert`, and must equal the JAX package's host oracle
RefBackend bit for bit; EvalFunc also equals its JaxBackend on the CPU.
Last, the port's plain 64-bit rotation equals the JAX package's Pallas
kernel, run in interpret mode as tests/test_pallas.py runs it, at N = 8192
and d2 = 4 with one digit thrown, over two rounds."""

import numpy as np
import pytest
import torch
from test_torch_ring8192_rns import assert_same, carry, port_context

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import ParamSet
from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.ops import pallas_rotate64 as pr64
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import rotate64_kernel
from torch_threads import one_torch_thread  # noqa: F401

N = 8192
Q54 = 18014398508400641                 # ntt_prime(54, 16384), the prime at N = 8192


@pytest.fixture(scope="module")
def two_limb():
    """The sign/decomp context (logQ 17, time optimization, bases {2^18,
    2^27}, one digit thrown) and the EvalFunc context (logQ 12, arbFunc) on
    its base-2^27 key (the same gadget, digits, ring and LWE secrets and
    switching key, so one keygen fewer), both at the single prime, each
    beside the port's context on the same keys (whose device keys are packed
    once for the module)."""
    sign = JaxContext(seed=8301)
    sign.generate_binfhe_context(ParamSet.TOY, arb_func=False, log_q=17, N=N,
                                 num_digits_to_throw=1, time_optimization=True,
                                 rns_modulus=False)
    sk = sign.key_gen()
    sign.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    func = JaxContext(seed=8302)
    func.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12, N=N,
                                 num_digits_to_throw=1, rns_modulus=False)
    func.bt_key_load(sign.bt_key_map[1 << 27])
    return (sign, port_context(sign)), (func, port_context(func)), sk


def test_sets_take_the_two_limb_path(two_limb):
    (sign, _), (func, _), _ = two_limb
    for jc, d2 in ((sign, 4), (func, 2)):
        p = convert.params_from(jc.params)
        assert p.rgsw.N == N and p.lwe.Q == Q54 and p.rgsw.rns_primes is None
        assert p.rgsw.digits_g2 == d2 and TorchBackend._path(p) == "two_limb"
        assert TorchBackend.supports(p)


def test_eval_sign_matches_oracle(two_limb):
    (jc, tc), _, sk = two_limb
    Q_enc = 1 << 17
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    delta = np.array([-1, 0])
    ct = jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    got = tc.eval_sign(carry(ct))
    assert isinstance(tc.backend, TorchBackend) and tc.backend.device.type == "cpu"
    assert_same(jc.eval_sign(ct), got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))
    assert len(tc.backend._device_keys) == 2     # both gadget bases' keys


def test_eval_decomp_matches_oracle(two_limb):
    (jc, tc), _, sk = two_limb
    Q_enc = 1 << 23
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    ct = jc.encrypt(sk, np.array([P - 1]), "FRESH", P, Q_enc)   # every digit the largest
    got = tc.eval_decomp(carry(ct))
    want = jc.eval_decomp(ct)
    assert len(want) == len(got) >= 2
    for w, g in zip(want, got):
        assert_same(w, g)


def test_eval_func_matches_oracle_and_jax(two_limb):
    _, (jc, tc), sk = two_limb
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([p - 1])                       # the LUT's last entry
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = tc.eval_func(carry(ct), lut)
    assert_same(jc.eval_func(ct, lut), got)
    jc.device_setup()
    try:
        on_jax = jc.eval_func(ct, lut)
    finally:
        jc.device_clean()
    assert_same(on_jax, got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64), (m ** 3) % p)


def test_plain_rotate64_matches_pallas_kernel():
    """EvalSign's first shape: base 2^18, one of three digits thrown
    (d2 = 4), B = 2 over two rounds, the exponents 0, N, 2N - 1 and 1 among
    them."""
    B, n, base_log, digits, throw = 2, 2, 18, 3, 1
    rng = np.random.default_rng(8192 + 64)
    acc = rng.integers(0, Q54, (B, 2, N)).astype(np.uint64)
    a_idx = np.array([[0, N], [2 * N - 1, 1]], dtype=np.int32)
    d2 = 2 * (digits - throw)
    bsk_coeff = rng.integers(0, Q54, (n, 2, d2, 2, N)).astype(np.uint64)
    pfn = pr64.build_pallas_rotate64(N, Q54, 1 << base_log, digits - throw, throw, n,
                                     BT=B, bt=B)
    want = pfn(*mm64.pack_host(acc), a_idx, pr64.pack_bsk64(ref_ntt.forward(bsk_coeff, Q54),
                                                            Q54))
    got = rotate64_kernel.rotate64(
        torch.from_numpy(acc.astype(np.int64)), torch.from_numpy(a_idx),
        rotate64_kernel.pack_bsk64(bsk_coeff, Q54), Q54, 1 << base_log, throw)
    assert np.array_equal(got.numpy().astype(np.uint64),
                          mm64.unpack_host(np.asarray(want[0]), np.asarray(want[1])))
