"""Ring dimension N = 8192 in the port, on the CPU.

The mixed logQ = 11 TOY sets at N = 8192 (`from_gpu_style(TOY, ...,
log_q=11, N=8192)`: n = 32, Q = 133857281, base 2^5, qKS = 2^35): NAND and
XOR with one digit thrown (d2 = 10), EvalFloor there, and EvalFunc at
arbFunc (q = 8192, no digit thrown, d2 = 12), on the gate kernel's path.
Each runs through the port's context with device "cpu" (the kernel's plain
version) on the JAX package's keys and ciphertexts, carried across with
`tfhe_tpu_torch.convert`, and must equal the JAX package's host oracle
RefBackend bit for bit; EvalFloor and EvalFunc also equal its JaxBackend
on the CPU. Last, the port's plain rotation equals the JAX package's
Pallas kernel, run in interpret mode as tests/test_pallas.py runs it, at
N = 8192 and d2 = 10 over two rounds. The two contexts share one LWE
secret, ring secret and switching key ([1835008, 32] at n = 32), carried
across once."""

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import Gate, ParamSet
from tfhe_tpu.ops import pallas_rotate as pr
from tfhe_tpu.ref import ntt as ref_ntt
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import rotate_kernel
from torch_threads import one_torch_thread  # noqa: F401

N = 8192
Q = 133857281                          # ntt_prime(27, 2N): the logQ = 11 prime at N = 8192
TRUTH = {
    Gate.NAND: lambda a, b: 1 - (a & b),
    Gate.XOR: lambda a, b: a ^ b,
}
M1 = np.array([0, 1, 1, 0])
M2 = np.array([1, 1, 0, 0])


@pytest.fixture(scope="module")
def contexts():
    """from_gpu_style(TOY, False, 11, N=8192) with one digit thrown, and
    from_gpu_style(TOY, True, 11, N=8192) on its secrets and switching key;
    each beside the port's context on the same keys, the switching key
    carried across once."""
    gate = JaxContext(seed=8201)
    gate.generate_binfhe_context(ParamSet.TOY, arb_func=False, log_q=11, N=N,
                                 num_digits_to_throw=1)
    sk = gate.key_gen()
    gate.bt_key_gen(sk)
    func = JaxContext(seed=8202)
    func.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=11, N=N)
    func.bt_key_gen(sk, sk_n=gate.bt_key.sk_n, ksk=gate.bt_key.ksk)
    ksk = convert.switching_key_from(gate.bt_key.ksk)
    ports = []
    for jc in (gate, func):
        tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
        tc.params = convert.params_from(jc.params)
        key = convert.key_from(jc.bt_key)
        key.ksk = ksk
        tc.bt_key_load(key)
        ports.append(tc)
    return (gate, ports[0]), (func, ports[1]), sk


def carry(ct):
    return convert.ciphertext_from(ct)


def assert_same(want, got):
    assert want.modulus == got.modulus
    assert np.array_equal(np.asarray(want.a), np.asarray(got.a))
    assert np.array_equal(np.asarray(want.b), np.asarray(got.b))


def on_jax_backend(jc, op):
    """op() under the JAX package's JaxBackend on the CPU, then back on its
    host oracle."""
    jc.device_setup()
    try:
        return op()
    finally:
        jc.device_clean()


def test_sets_take_the_mixed_path(contexts):
    (gate, tc), (func, fc), _ = contexts
    for jc, port in ((gate, tc), (func, fc)):
        p = convert.params_from(jc.params)
        assert p.rgsw.N == N and p.lwe.Q == Q and TorchBackend._path(p) == "mixed"
        assert port.params.rgsw.digits_g2 == (10 if jc is gate else 12)


@pytest.mark.parametrize("gate_op", list(TRUTH), ids=lambda g: g.name)
def test_mixed_gate_matches_oracle(contexts, gate_op):
    (jc, tc), _, sk = contexts
    ct1, ct2 = jc.encrypt(sk, M1), jc.encrypt(sk, M2)
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate(int(gate_op)), carry(ct1), carry(ct2))
    assert isinstance(tc.backend, TorchBackend) and tc.backend.device.type == "cpu"
    assert_same(jc.eval_bin_gate(gate_op, ct1, ct2), got)
    assert np.array_equal(jc.decrypt(sk, got), TRUTH[gate_op](M1, M2))


def test_mixed_eval_floor_matches_oracle_and_jax(contexts):
    (jc, tc), _, sk = contexts
    p = jc.get_max_plaintext_space()
    m = np.array([1, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = tc.eval_floor(carry(ct), 1)
    assert_same(jc.eval_floor(ct, 1), got)
    assert_same(on_jax_backend(jc, lambda: jc.eval_floor(ct, 1)), got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p // 2), dtype=np.int64), m // 2)


def test_mixed_eval_func_matches_oracle_and_jax(contexts):
    _, (jc, tc), sk = contexts
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([2, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = tc.eval_func(carry(ct), lut)
    assert_same(jc.eval_func(ct, lut), got)
    assert_same(on_jax_backend(jc, lambda: jc.eval_func(ct, lut)), got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64), (m ** 3) % p)


def test_plain_rotation_matches_pallas_kernel():
    """The N = 8192 mixed shape: base 2^5, one of six digits thrown
    (d2 = 10), B = 2 over two rounds, the exponents 0, N and 2N - 1 among
    them."""
    B, n, base_g, digits, throw = 2, 2, 1 << 5, 6, 1
    rng = np.random.default_rng(8192)
    acc = rng.integers(0, Q, (B, 2, N)).astype(np.uint32)
    a_idx = np.array([[0, N], [2 * N - 1, 1]], dtype=np.int32)
    bsk_hat = ref_ntt.forward(
        rng.integers(0, Q, (n, 2, 2 * (digits - throw), 2, N)).astype(np.uint64), Q)
    pfn = pr.build_pallas_rotate(N, Q, base_g, digits - throw, throw, n, BT=B, bt=B)
    want = np.asarray(pfn(acc, a_idx, pr.pack_bsk(bsk_hat, Q)))
    got = rotate_kernel.rotate(torch.from_numpy(acc.astype(np.int32)),
                               torch.from_numpy(a_idx), rotate_kernel.pack_bsk(bsk_hat, Q),
                               Q, base_g, throw)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
