"""Ring dimension N = 4096 in the port, on the CPU.

The accelerated TOY sets at N = 4096 (`from_gpu_style(TOY, ..., N=4096)`,
n = 32, qKS = 2^35): EvalSign (logQ 17), EvalDecomp (logQ 23) and EvalFunc
(logQ 12, arbFunc) on the RNS path (Q = q1*q2), EvalFloor and every gate at
logQ 11 on the mixed path. Each runs through the port's context with device
"cpu" (the kernels' plain versions) on the JAX package's keys and
ciphertexts, carried across with `tfhe_tpu_torch.convert`, and must equal
the JAX package's host oracle RefBackend bit for bit; EvalFunc and
EvalFloor also equal its JaxBackend on the CPU. Last, the port's plain
rotations equal the JAX package's Pallas kernels, run in interpret mode as
tests/test_pallas.py runs them, at N = 4096 over a few rounds."""

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import Gate, ParamSet
from tfhe_tpu.ops import pallas_rotate as pr
from tfhe_tpu.ops import pallas_rotate_rns as prr
from tfhe_tpu.ref import ntt as ref_ntt
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import rotate64_kernel, rotate_kernel, rotate_rns_kernel
from torch_threads import one_torch_thread  # noqa: F401

N = 4096
Q1, Q2 = 134176769, 134111233          # the accelerated sets' primes at N = 4096
TRUTH = {
    Gate.OR: lambda a, b: a | b,
    Gate.AND: lambda a, b: a & b,
    Gate.NOR: lambda a, b: 1 - (a | b),
    Gate.NAND: lambda a, b: 1 - (a & b),
    Gate.XOR_FAST: lambda a, b: a ^ b,
    Gate.XNOR_FAST: lambda a, b: 1 - (a ^ b),
    Gate.XOR: lambda a, b: a ^ b,
    Gate.XNOR: lambda a, b: 1 - (a ^ b),
}
M1 = np.array([0, 1, 1, 0])
M2 = np.array([1, 1, 0, 0])


def jax_context(seed, shared=None, bases=None, **kw):
    """A JAX-package context at from_gpu_style(TOY, ..., N=4096); its keys
    on `shared` = (sk, sk_n, ksk) when given."""
    jc = JaxContext(seed=seed)
    jc.generate_binfhe_context(ParamSet.TOY, N=N, **kw)
    if shared is None:
        sk = jc.key_gen()
        jc.bt_key_gen(sk, bases=bases)
        return jc, (sk, jc.bt_key.sk_n, jc.bt_key.ksk)
    jc.bt_key_gen(shared[0], sk_n=shared[1], ksk=shared[2], bases=bases)
    return jc, shared


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
    2^27}, one digit thrown) and the EvalFunc context (logQ 12, arbFunc),
    on one LWE secret, ring secret and switching key."""
    sign, shared = jax_context(5201, arb_func=False, log_q=17, num_digits_to_throw=1,
                               time_optimization=True, bases={1 << 18, 1 << 27})
    func, _ = jax_context(5202, shared, arb_func=True, log_q=12, num_digits_to_throw=1)
    return sign, func, shared[0]


@pytest.fixture(scope="module")
def mixed():
    """from_gpu_style(TOY, False, 11, N=4096) with one digit thrown."""
    jc, shared = jax_context(5203, arb_func=False, log_q=11, num_digits_to_throw=1)
    return jc, port_context(jc), shared[0]


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


def test_kernel_wrappers_take_their_rings():
    """The gate, RNS and 64-bit kernels take N = 4096 and N = 8192; the RNS
    kernel also takes N = 16384 and refuses N = 32768, the other two refuse
    N = 16384."""
    assert N in rotate_kernel.RING_DIMS and rotate_kernel.RING_DIMS[-1] == 2 * N
    assert rotate_rns_kernel.RING_DIMS[-1] == 4 * N and rotate64_kernel.RING_DIMS[-1] == 2 * N
    rotate_rns_kernel.check_params(N, 4, Q1, Q2, 1 << 18)
    rotate_rns_kernel.check_params(2 * N, 4, 133857281, 133644289, 1 << 18)
    rotate_rns_kernel.check_params(4 * N, 4, 133857281, 132710401, 1 << 18)
    rotate64_kernel.check_params(N, 4, (1 << 54) - 33, 1 << 18)
    rotate64_kernel.check_params(2 * N, 4, (1 << 54) - 33, 1 << 18)
    with pytest.raises(ValueError):
        rotate_rns_kernel.check_params(8 * N, 4, Q1, Q2, 1 << 18)
    with pytest.raises(ValueError):
        rotate64_kernel.check_params(4 * N, 4, (1 << 54) - 33, 1 << 18)


def test_sets_take_the_rns_and_mixed_paths(rns, mixed):
    sign, func, _ = rns
    for jc, path in ((sign, "rns"), (func, "rns"), (mixed[0], "mixed")):
        p = convert.params_from(jc.params)
        assert p.rgsw.N == N and TorchBackend._path(p) == path


def test_eval_func_matches_oracle_and_jax(rns):
    _, jc, sk = rns
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([2, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    tc = port_context(jc)
    got = tc.eval_func(carry(ct), lut)
    assert isinstance(tc.backend, TorchBackend) and tc.backend.device.type == "cpu"
    assert_same(jc.eval_func(ct, lut), got)
    assert_same(on_jax_backend(jc, lambda: jc.eval_func(ct, lut)), got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64), (m ** 3) % p)


def test_eval_sign_matches_oracle(rns):
    jc, _, sk = rns
    Q_enc = 1 << 17
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    delta = np.array([-1, 0])
    ct = jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    tc = port_context(jc)
    got = tc.eval_sign(carry(ct))
    assert_same(jc.eval_sign(ct), got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))
    assert len(tc.backend._device_keys) == 2     # both gadget bases' keys


def test_eval_decomp_matches_oracle(rns):
    jc, _, sk = rns
    Q_enc = 1 << 23
    P = jc.get_max_plaintext_space() * (Q_enc // jc.params.lwe.q)
    ct = jc.encrypt(sk, np.array([P // 3, P - 1]), "FRESH", P, Q_enc)
    got = port_context(jc).eval_decomp(carry(ct))
    want = jc.eval_decomp(ct)
    assert len(want) == len(got) >= 2
    for w, g in zip(want, got):
        assert_same(w, g)


def test_mixed_eval_floor_matches_oracle_and_jax(mixed):
    jc, tc, sk = mixed
    p = jc.get_max_plaintext_space()
    m = np.array([1, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = tc.eval_floor(carry(ct), 1)
    assert_same(jc.eval_floor(ct, 1), got)
    assert_same(on_jax_backend(jc, lambda: jc.eval_floor(ct, 1)), got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p // 2), dtype=np.int64), m // 2)


@pytest.mark.parametrize("gate", list(Gate), ids=lambda g: g.name)
def test_mixed_gate_matches_oracle(mixed, gate):
    jc, tc, sk = mixed
    ct1, ct2 = jc.encrypt(sk, M1), jc.encrypt(sk, M2)
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate(int(gate)), carry(ct1), carry(ct2))
    assert_same(jc.eval_bin_gate(gate, ct1, ct2), got)
    assert np.array_equal(jc.decrypt(sk, got), TRUTH[gate](M1, M2))


B, n = 4, 2


@pytest.mark.parametrize("base_log,digits,throw", [(18, 3, 1), (27, 2, 1)],
                         ids=["base18", "base27"])
def test_plain_rns_rotation_matches_pallas_kernel(base_log, digits, throw):
    rng = np.random.default_rng(base_log)
    acc = rng.integers(0, Q1 * Q2, (B, 2, N)).astype(np.uint64)
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[:3] = np.array([0, N, 2 * N - 1])[:, None]
    d2 = 2 * (digits - throw)
    bsk = rng.integers(0, Q1 * Q2, (n, 2, d2, 2, N)).astype(np.uint64)
    lanes = [(acc % np.uint64(q)).astype(np.uint32) for q in (Q1, Q2)]
    rfn = prr.build_pallas_rotate_rns(N, Q1, Q2, 1 << base_log, digits - throw, throw,
                                      n, BT=4, bt=4)
    want = rfn(*lanes, a_idx, prr.pack_bsk_rns(bsk, Q1, Q2))
    got = rotate_rns_kernel.rotate_rns(
        *[torch.from_numpy(x.astype(np.int32)) for x in lanes], torch.from_numpy(a_idx),
        rotate_rns_kernel.pack_bsk_rns(bsk, Q1, Q2), Q1, Q2, 1 << base_log, throw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int32))


def test_plain_rotation_matches_pallas_kernel():
    """The mixed logQ = 11 shape: Q = 134176769, base 2^5, one of six
    digits thrown (d2 = 10)."""
    Q, base_g, digits, throw = Q1, 1 << 5, 6, 1
    rng = np.random.default_rng(11)
    acc = rng.integers(0, Q, (B, 2, N)).astype(np.uint32)
    a_idx = rng.integers(0, 2 * N, (B, n)).astype(np.int32)
    a_idx[:3] = np.array([0, N, 2 * N - 1])[:, None]
    bsk_hat = ref_ntt.forward(
        rng.integers(0, Q, (n, 2, 2 * (digits - throw), 2, N)).astype(np.uint64), Q)
    pfn = pr.build_pallas_rotate(N, Q, base_g, digits - throw, throw, n, BT=4, bt=4)
    want = np.asarray(pfn(acc, a_idx, pr.pack_bsk(bsk_hat, Q)))
    got = rotate_kernel.rotate(torch.from_numpy(acc.astype(np.int32)),
                               torch.from_numpy(a_idx), rotate_kernel.pack_bsk(bsk_hat, Q),
                               Q, base_g, throw)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
