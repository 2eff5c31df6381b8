"""Ring dimension N = 8192 on the port's RNS path, on the CPU.

The accelerated TOY sets at N = 8192 (`from_gpu_style(TOY, ..., N=8192)`:
n = 32, Q = q1*q2 = 133857281 * 133644289, qKS = 2^35, one digit thrown):
EvalSign with the gadget bases 2^18 and 2^27 and EvalDecomp (logQ 17 and 23,
q = 16384), and EvalFunc at arbFunc (logQ 12, q = 8192, base 2^27), on one
LWE secret, ring secret and switching key. Each runs through the port's
context with device "cpu" (the kernel's plain version) on the JAX package's
keys and ciphertexts, carried across with `tfhe_tpu_torch.convert`, and must
equal the JAX package's host oracle RefBackend bit for bit; EvalFunc also
equals its JaxBackend on the CPU. Last, the port's plain RNS rotation equals
the JAX package's Pallas kernel, run in interpret mode as
tests/test_pallas.py runs it, at N = 8192 and d2 = 4 with one digit thrown,
over two rounds."""

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import ParamSet
from tfhe_tpu.ops import pallas_rotate_rns as prr
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import rotate_rns_kernel
from torch_threads import one_torch_thread  # noqa: F401

N = 8192
Q1, Q2 = 133857281, 133644289          # the accelerated sets' primes at N = 8192


def port_context(jc):
    """The port's context (device "cpu") on a JAX context's parameters and
    keys, the default gadget base's key loaded last."""
    tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    tc.params = convert.params_from(jc.params)
    default = jc.params.rgsw.base_g
    for base in sorted(jc.bt_key_map, key=lambda b: b == default):
        tc.bt_key_load(convert.key_from(jc.bt_key_map[base]))
    return tc


@pytest.fixture(scope="module")
def rns():
    """The sign/decomp context (logQ 17, time optimization, bases {2^18,
    2^27}, one digit thrown) and the EvalFunc context (logQ 12, arbFunc) on
    its LWE secret, ring secret and switching key, each beside the port's
    context on the same keys."""
    sign = JaxContext(seed=8211)
    sign.generate_binfhe_context(ParamSet.TOY, arb_func=False, log_q=17, N=N,
                                 num_digits_to_throw=1, time_optimization=True)
    sk = sign.key_gen()
    sign.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    func = JaxContext(seed=8212)
    func.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12, N=N,
                                 num_digits_to_throw=1)
    func.bt_key_gen(sk, sk_n=sign.bt_key.sk_n, ksk=sign.bt_key.ksk)
    return (sign, port_context(sign)), (func, port_context(func)), sk


def carry(ct):
    return convert.ciphertext_from(ct)


def assert_same(want, got):
    assert want.modulus == got.modulus
    assert np.array_equal(np.asarray(want.a), np.asarray(got.a))
    assert np.array_equal(np.asarray(want.b), np.asarray(got.b))


def test_kernel_takes_the_ring():
    rotate_rns_kernel.check_params(N, 4, Q1, Q2, 1 << 18)
    rotate_rns_kernel.check_params(N, 2, Q1, Q2, 1 << 27)
    with pytest.raises(ValueError):
        rotate_rns_kernel.check_params(4 * N, 4, Q1, Q2, 1 << 18)


def test_sets_take_the_rns_path(rns):
    (sign, _), (func, _), _ = rns
    for jc, d2 in ((sign, 4), (func, 2)):
        p = convert.params_from(jc.params)
        assert p.rgsw.N == N and p.rgsw.rns_primes == (Q1, Q2)
        assert p.rgsw.digits_g2 == d2 and TorchBackend._path(p) == "rns"
        assert TorchBackend.supports(p)


def test_eval_sign_matches_oracle(rns):
    (jc, tc), _, sk = rns
    Q_enc = 1 << 17
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    delta = np.array([-1, 0])
    ct = jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    got = tc.eval_sign(carry(ct))
    assert isinstance(tc.backend, TorchBackend) and tc.backend.device.type == "cpu"
    assert_same(jc.eval_sign(ct), got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))
    assert len(tc.backend._device_keys) == 2     # both gadget bases' keys


def test_eval_decomp_matches_oracle(rns):
    (jc, tc), _, sk = rns
    Q_enc = 1 << 23
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    ct = jc.encrypt(sk, np.array([P // 3, P - 1]), "FRESH", P, Q_enc)
    got = tc.eval_decomp(carry(ct))
    want = jc.eval_decomp(ct)
    assert len(want) == len(got) >= 2
    for w, g in zip(want, got):
        assert_same(w, g)


def test_eval_func_matches_oracle_and_jax(rns):
    _, (jc, tc), sk = rns
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([2, p - 1])
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


def test_plain_rns_rotation_matches_pallas_kernel():
    """EvalSign's first shape: base 2^18, one of three digits thrown
    (d2 = 4), B = 2 over two rounds, the exponents 0, N and 2N - 1 among
    them."""
    B, n, base_log, digits, throw = 2, 2, 18, 3, 1
    rng = np.random.default_rng(8192 + base_log)
    acc = rng.integers(0, Q1 * Q2, (B, 2, N)).astype(np.uint64)
    a_idx = np.array([[0, N], [2 * N - 1, 1]], dtype=np.int32)
    d2 = 2 * (digits - throw)
    bsk = rng.integers(0, Q1 * Q2, (n, 2, d2, 2, N)).astype(np.uint64)
    lanes = [(acc % np.uint64(q)).astype(np.uint32) for q in (Q1, Q2)]
    rfn = prr.build_pallas_rotate_rns(N, Q1, Q2, 1 << base_log, digits - throw, throw,
                                      n, BT=B, bt=B)
    want = rfn(*lanes, a_idx, prr.pack_bsk_rns(bsk, Q1, Q2))
    got = rotate_rns_kernel.rotate_rns(
        *[torch.from_numpy(x.astype(np.int32)) for x in lanes], torch.from_numpy(a_idx),
        rotate_rns_kernel.pack_bsk_rns(bsk, Q1, Q2), Q1, Q2, 1 << base_log, throw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int32))
