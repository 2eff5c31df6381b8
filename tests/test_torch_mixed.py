"""The mixed logQ = 11 slice of the port (the u32 rotation kernel's layout
with the key switch that scales a 27-bit Q up to qKS = 2^35) on the CPU,
against the JAX package's JaxBackend and its host oracle RefBackend,
bit for bit, on the JAX package's keys and ciphertexts carried across with
`tfhe_tpu_torch.convert`: the gates, EvalFloor and EvalFunc at
`from_gpu_style(TOY, False|True, 11)` with no digit and one digit thrown,
RoundqQ at the edge of int64, and the fast paths the slice takes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import Gate, ParamSet
from tfhe_tpu import params as jax_params
from tfhe_tpu.ops import modmath64
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.ref.backend import RefBackend
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import backend as backend_mod
from tfhe_tpu_torch.ops.modmath import round_q_Q
from torch_threads import one_torch_thread  # noqa: F401

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
M1 = np.array([0, 0, 1, 1, 0, 1, 1, 0])
M2 = np.array([0, 1, 0, 1, 1, 1, 0, 0])


@pytest.fixture(scope="module")
def contexts():
    """JAX contexts at from_gpu_style(TOY, arb_func, 11) for arb_func in
    (False, True) and throw in (0, 1), on one LWE secret, ring secret and
    switching key (the four share n, N, Q, qKS and baseKS)."""
    out, shared = {}, None
    for arb in (False, True):
        for throw in (0, 1):
            jc = JaxContext(seed=4100 + 2 * arb + throw)
            jc.generate_binfhe_context(ParamSet.TOY, arb_func=arb, log_q=11,
                                       num_digits_to_throw=throw)
            if shared is None:
                sk = jc.key_gen()
                jc.bt_key_gen(sk)
                shared = (sk, jc.bt_key.sk_n, jc.bt_key.ksk)
            else:
                jc.bt_key_gen(shared[0], sk_n=shared[1], ksk=shared[2])
            out[arb, throw] = jc
    return out, shared[0]


def port_context(jc):
    """The port's context (device "cpu") on a JAX context's parameters and key."""
    tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    tc.params = convert.params_from(jc.params)
    tc.bt_key_load(convert.key_from(jc.bt_key))
    return tc


def carry(ct):
    return convert.ciphertext_from(ct)


def assert_same(want, got):
    assert want.modulus == got.modulus
    assert np.array_equal(np.asarray(want.a), np.asarray(got.a))
    assert np.array_equal(np.asarray(want.b), np.asarray(got.b))


def jax_backend(jc):
    be = JaxBackend()
    be.setup(jc.params, jc.bt_key)
    return be


@pytest.mark.parametrize("param_set", [ParamSet.TOY, ParamSet.STD128], ids=lambda s: s.name)
def test_logq11_sets_are_supported_as_in_jax(param_set):
    """Every logQ = 11 set (arbFunc or not, 0 or 1 digit thrown) takes the
    mixed path, as JaxBackend takes it, at the set's own ring and at
    N = 8192; at N = 16384, which JaxBackend also takes, the port refuses
    what the kernel cannot run."""
    for arb in (False, True):
        for throw in (0, 1):
            for N in (0, 8192):
                jp = jax_params.from_gpu_style(param_set, arb, 11, N=N,
                                               num_digits_to_throw=throw)
                tp = convert.params_from(jp)
                assert TorchBackend.supports(tp) == JaxBackend().supports(jp) is True
                assert TorchBackend._path(tp) == "mixed"
    big = convert.params_from(jax_params.from_gpu_style(param_set, False, 11, N=16384))
    assert JaxBackend().supports(jax_params.from_gpu_style(param_set, False, 11, N=16384))
    assert TorchBackend._path(big) is None


@pytest.mark.parametrize("throw", [0, 1], ids=["throw0", "throw1"])
@pytest.mark.parametrize("gate", list(Gate), ids=lambda g: g.name)
def test_mixed_gate_matches_jax_and_oracle(contexts, gate, throw):
    ctxs, sk = contexts
    jc = ctxs[False, throw]
    ct1, ct2 = jc.encrypt(sk, M1), jc.encrypt(sk, M2)
    tc = port_context(jc)
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate(int(gate)), carry(ct1), carry(ct2))
    assert np.array_equal(jc.decrypt(sk, got), TRUTH[gate](M1, M2))
    jc.device_clean()
    assert_same(jc.eval_bin_gate(gate, ct1, ct2), got)
    jc.use_backend(jax_backend(jc))
    assert_same(jc.eval_bin_gate(gate, ct1, ct2), got)


@pytest.mark.parametrize("throw", [0, 1], ids=["throw0", "throw1"])
def test_mixed_floor_matches_jax_and_oracle(contexts, throw):
    """EvalFloor (the JAX bench's floor row at TOY width): both bootstraps
    on the port's device chain."""
    ctxs, sk = contexts
    jc = ctxs[False, throw]
    p = jc.get_max_plaintext_space()
    m = np.array([0, 1, p // 2 - 1, p // 2, p - 1, 3 % p])
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = port_context(jc).eval_floor(carry(ct), 1)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p // 2), dtype=np.int64), m // 2)
    jc.device_clean()
    assert_same(jc.eval_floor(ct, 1), got)
    jc.use_backend(jax_backend(jc))
    assert_same(jc.eval_floor(ct, 1), got)


@pytest.mark.parametrize("throw", [0, 1], ids=["throw0", "throw1"])
def test_mixed_func_matches_jax_and_oracle(contexts, throw):
    """EvalFunc of an arbitrary (not negacyclic) LUT at arbFunc, q = N."""
    ctxs, sk = contexts
    jc = ctxs[True, throw]
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m + 1) % p1, p)
    m = np.arange(2 * p) % p
    ct = jc.encrypt(sk, m, "FRESH", p)
    got = port_context(jc).eval_func(carry(ct), lut)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64),
                          (m ** 3 + 1) % p)
    jc.device_clean()
    assert_same(jc.eval_func(ct, lut), got)
    jc.use_backend(jax_backend(jc))
    assert_same(jc.eval_func(ct, lut), got)


def test_round_q_Q_scales_up_at_the_edge_of_int64(contexts):
    """2(Q-1) qKS + Q lies within 2^-16 of 2^63 at Q = 134215681, qKS = 2^35:
    RoundqQ's one-division branch at v in {0, Q/2 - 1, Q/2, Q/2 + 1, Q - 1}
    against the exact rational rounding, the JAX package's `round_q_Q64`,
    and the whole MKM switch against `build_mkm_switch64` (JaxBackend) and
    the host oracle on ciphertexts made of those values."""
    ctxs, _ = contexts
    jc = ctxs[False, 0]
    p = jc.params.lwe
    Q, q_ks = p.Q, p.q_ks
    assert Q == 134215681 and q_ks == 1 << 35
    assert (1 << 63) - (2 * (Q - 1) * q_ks + Q) < (1 << 47)
    edge = np.array([0, Q // 2 - 1, Q // 2, Q // 2 + 1, Q - 1], dtype=np.uint64)
    got = round_q_Q(torch.from_numpy(edge.astype(np.int64)), q_ks, Q).numpy()
    exact = [(2 * int(v) * q_ks + Q) // (2 * Q) % q_ks for v in edge]
    assert got.tolist() == exact
    pair = (jnp.asarray((edge & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((edge >> np.uint64(32)).astype(np.uint32)))
    lo, hi = modmath64.round_q_Q64(pair, q_ks, Q)
    assert (np.asarray(lo).astype(np.uint64)
            | (np.asarray(hi).astype(np.uint64) << np.uint64(32))).tolist() == exact

    rng = np.random.default_rng(11)
    a_ext = edge[rng.integers(0, len(edge), (len(edge), p.N))]
    b_ext = edge.copy()
    tparams, tkey = convert.params_from(jc.params), convert.key_from(jc.bt_key)
    for fmod in (p.q, 1 << 20):
        got_ct = TorchBackend("cpu").mkm_switch(tparams, tkey, a_ext, b_ext, fmod)
        assert_same(jax_backend(jc).mkm_switch(jc.params, jc.bt_key, a_ext, b_ext, fmod),
                    got_ct)
        assert_same(RefBackend().mkm_switch(jc.params, jc.bt_key, a_ext, b_ext, fmod),
                    got_ct)


def test_mixed_takes_the_fused_gate_path_and_the_device_chain(contexts, monkeypatch):
    """The gate takes the fused path (u16 in and out), the test polynomial
    at q = 2N has factor 1, and EvalFloor keeps its ciphertext on the
    device between its two bootstraps, each through the kernel's wrapper."""
    ctxs, sk = contexts
    jc = ctxs[False, 1]
    tc = port_context(jc)
    params, key = tc.params, tc.bt_key
    be = TorchBackend("cpu")
    assert be._path(params) == "mixed" and be.chain_supported(params, key)
    assert params.lwe.q == 2 * params.rgsw.N
    ct1, ct2 = carry(jc.encrypt(sk, M1)), carry(jc.encrypt(sk, M2))
    out = be.gate_bootstrap_pair(params, key, tfhe_tpu_torch.Gate.AND, ct1, ct2, False,
                                 params.lwe.q)
    assert out is not None and out.a.dtype == np.uint16
    assert np.array_equal(jc.decrypt(sk, out), M1 & M2)

    calls, uploads = [], []
    rotate, upload = backend_mod.rotate, TorchBackend.lwe_upload
    monkeypatch.setattr(backend_mod, "rotate",
                        lambda *args: calls.append(args[0].shape) or rotate(*args))
    monkeypatch.setattr(TorchBackend, "lwe_upload",
                        lambda self, ct: uploads.append(ct) or upload(self, ct))
    p = jc.get_max_plaintext_space()
    ct = jc.encrypt(sk, np.array([1, p - 2]), "FRESH", p)
    tc.use_backend(be)
    out = tc.eval_floor(carry(ct), 1)
    assert len(uploads) == 1 and len(calls) == 2
    assert np.array_equal(np.asarray(jc.decrypt(sk, out, p // 2), dtype=np.int64),
                          np.array([0, p // 2 - 1]))
