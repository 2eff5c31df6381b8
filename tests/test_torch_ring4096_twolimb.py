"""Ring dimension N = 4096 at the reference's single 54-bit prime, on the CPU.

The accelerated TOY sets at N = 4096 with `rns_modulus=False`
(`from_gpu_style(TOY, ..., N=4096, rns_modulus=False)`: n = 32, qKS = 2^35,
Q = ntt_prime(54, 8192)) take the port's two-limb path, whose kernel is
`csrc/blind_rotate64.cu` (a cluster of two blocks at this ring). EvalSign
(logQ 17, bases 2^18 and 2^27), EvalDecomp and EvalFunc (logQ 12, arbFunc)
run through the port's context with device "cpu" (the plain rotation) on
the JAX package's keys and ciphertexts, carried across with
`tfhe_tpu_torch.convert`, and must equal the JAX package's host oracle
RefBackend bit for bit; EvalFunc also equals its JaxBackend on the CPU. The
port's own host oracle, which runs such a set's Python-int accumulators
through its native engine, equals the JAX package's round loop. Last, the
port's plain 64-bit rotation equals the JAX package's Pallas kernel in
interpret mode (as tests/test_pallas.py runs it) and its XLA rotation at
N = 4096 over a few rounds."""

import numpy as np
import pytest
import torch
from test_torch_ring4096 import (N, assert_same, carry, jax_context, on_jax_backend,
                                 port_context)

from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.ops import pallas_rotate64 as pr64
from tfhe_tpu.ops.blindrotate64 import build_blind_rotate64
from tfhe_tpu.ref.backend import RefBackend as JaxRefBackend
from tfhe_tpu.ref import ntt as ref_ntt
from tfhe_tpu.utils.numtheory import ntt_prime
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import rotate64_kernel
from tfhe_tpu_torch.ref.backend import RefBackend
from torch_threads import one_torch_thread  # noqa: F401

Q54 = ntt_prime(54, 2 * N)              # the single prime from_gpu_style derives at N = 4096


@pytest.fixture(scope="module")
def two_limb():
    """The sign/decomp context (logQ 17, time optimization, bases {2^18,
    2^27}, one digit thrown) and the EvalFunc context (logQ 12, arbFunc),
    both at the single prime, on one LWE secret, ring secret and switching
    key."""
    sign, shared = jax_context(5301, arb_func=False, log_q=17, num_digits_to_throw=1,
                               time_optimization=True, bases={1 << 18, 1 << 27},
                               rns_modulus=False)
    func, _ = jax_context(5302, shared, arb_func=True, log_q=12, num_digits_to_throw=1,
                          rns_modulus=False)
    return sign, func, shared[0]


def test_sets_take_the_two_limb_path(two_limb):
    sign, func, _ = two_limb
    for jc in (sign, func):
        p = convert.params_from(jc.params)
        assert p.rgsw.N == N and p.lwe.Q == Q54 and p.rgsw.rns_primes is None
        assert TorchBackend._path(p) == "two_limb"


def test_eval_sign_matches_oracle(two_limb):
    jc, _, sk = two_limb
    Q_enc = 1 << 17
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    delta = np.array([-1, 0])
    ct = jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    tc = port_context(jc)
    got = tc.eval_sign(carry(ct))
    assert isinstance(tc.backend, TorchBackend) and tc.backend.device.type == "cpu"
    assert_same(jc.eval_sign(ct), got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))
    assert len(tc.backend._device_keys) == 2     # both gadget bases' keys


def test_eval_decomp_matches_oracle(two_limb):
    jc, _, sk = two_limb
    Q_enc = 1 << 23
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    ct = jc.encrypt(sk, np.array([P // 3, P - 1]), "FRESH", P, Q_enc)
    got = port_context(jc).eval_decomp(carry(ct))
    want = jc.eval_decomp(ct)
    assert len(want) == len(got) >= 2
    for w, g in zip(want, got):
        assert_same(w, g)


def test_eval_func_matches_oracle_and_jax(two_limb):
    _, jc, sk = two_limb
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([2, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = port_context(jc).eval_func(carry(ct), lut)
    assert_same(jc.eval_func(ct, lut), got)
    assert_same(on_jax_backend(jc, lambda: jc.eval_func(ct, lut)), got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64), (m ** 3) % p)


def test_port_oracle_takes_python_int_accumulators_natively(two_limb):
    """The scheme builds the accumulator of a set with Q >= 2^31 from Python
    ints; the port's RefBackend runs it through the native engine (as
    uint64) and returns Python ints equal to the JAX package's RefBackend,
    which runs its numpy round loop on them."""
    jc, _, _ = two_limb
    rng = np.random.default_rng(17)
    acc = np.empty((2, 2, N), dtype=object)
    acc[...] = [[[int(x) for x in row] for row in pair]
                for pair in rng.integers(0, Q54, (2, 2, N))]
    q = jc.params.lwe.q
    a = rng.integers(0, q, (2, jc.params.lwe.n)).astype(np.uint64)
    want = JaxRefBackend().eval_acc(jc.params, jc.bt_key, acc.copy(), a, q)
    got = RefBackend().eval_acc(convert.params_from(jc.params),
                                convert.key_from(jc.bt_key), acc.copy(), a, q)
    assert got.dtype == object and all(type(x) is int for x in got.flat[:4])
    assert np.array_equal(got, want)


B, n, BASE_G, DIGITS = 2, 2, 1 << 18, 3


@pytest.mark.parametrize("throw", [0, 1])
def test_plain_rotate64_matches_pallas_and_xla(throw):
    """throw 1 against the Pallas kernel in interpret mode, throw 0 against
    the XLA rotation (tests/test_pallas.py holds the two equal to each
    other), as tests/test_torch_rotate64.py does at N = 128."""
    rng = np.random.default_rng(4096 + throw)
    acc = rng.integers(0, Q54, (B, 2, N)).astype(np.uint64)
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[0] = [0, 2 * N - 1]
    a_idx[1] = [N, 1]
    d2 = 2 * (DIGITS - throw)
    bsk_coeff = rng.integers(0, Q54, (n, 2, d2, 2, N)).astype(np.uint64)
    bsk_hat = ref_ntt.forward(bsk_coeff, Q54)
    got = rotate64_kernel.rotate64(
        torch.from_numpy(acc.astype(np.int64)), torch.from_numpy(a_idx),
        rotate64_kernel.pack_bsk64(bsk_coeff, Q54), Q54, BASE_G, throw)
    alo, ahi = mm64.pack_host(acc)
    if throw:
        pfn = pr64.build_pallas_rotate64(N, Q54, BASE_G, DIGITS - throw, throw, n, BT=2, bt=2)
        want = pfn(alo, ahi, a_idx, pr64.pack_bsk64(bsk_hat, Q54))
    else:
        fn = build_blind_rotate64(N, Q54, BASE_G, DIGITS - throw, throw, n)
        want = fn(alo, ahi, a_idx, *mm64.pack_host(bsk_hat), *mm64.shoup64(bsk_hat, Q54))
    assert np.array_equal(got.numpy().astype(np.uint64),
                          mm64.unpack_host(np.asarray(want[0]), np.asarray(want[1])))
