"""Every GINX row of the classic table through the port's TorchBackend on
the CPU (the kernels' plain versions), and the two-limb slice end to end,
against the JAX package, bit for bit, on the JAX package's keys and
ciphertexts carried across with `tfhe_tpu_torch.convert`.

The matrix is tests/test_paramsets_device.py's: full N, Q, qKS and bases,
the LWE dimension cut to 12, two accumulators; its JAX-backend cases use
the same keys and inputs, so a whole run shares their compiles. The nine
single-limb sets take the u32 rotation, the eight others (STD192, STD128Q,
STD192Q and their _OPT rows, STD256 and STD256_OPT) the 64-bit one."""

import dataclasses
import functools

import numpy as np
import pytest

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import lwe, scheme as jax_scheme
from tfhe_tpu import params as params_mod
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.params import Gate, Method, ParamSet
from tfhe_tpu.ref.backend import RefBackend
from tfhe_tpu.ref.rgsw import poly_transpose
from tfhe_tpu.utils.rng import BinFHERng
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch import params as torch_params
from torch_threads import one_torch_thread  # noqa: F401

_MINI_N = 12
TWO_LIMB = (ParamSet.STD192, ParamSet.STD192_OPT, ParamSet.STD256, ParamSet.STD256_OPT,
            ParamSet.STD128Q, ParamSet.STD128Q_OPT, ParamSet.STD192Q, ParamSet.STD192Q_OPT)


def _mini_params(param_set: ParamSet, method: Method = Method.GINX):
    p = params_mod.from_param_set(param_set, method)
    return params_mod.BinFHEParams(lwe=dataclasses.replace(p.lwe, n=_MINI_N), rgsw=p.rgsw)


@functools.lru_cache(maxsize=None)
def _case(param_set: ParamSet):
    """(params, key, acc, a) with the seeds of test_paramsets_device.py."""
    params = _mini_params(param_set)
    p = params.lwe
    rng = BinFHERng(1000 + p.N + p.Q % 97)
    key = jax_scheme.key_gen(rng, params, lwe.key_gen(rng, p.n, p.q_ks))
    nprng = np.random.default_rng(p.Q % 10007)
    acc = nprng.integers(0, p.Q, (2, 2, p.N)).astype(np.uint64)
    a = nprng.integers(0, p.q, (2, p.n)).astype(np.uint64)
    return params, key, acc, a


def _compare(param_set: ParamSet, other, rotation_other=None) -> None:
    """TorchBackend("cpu") against JAX-package backends: eval_acc against
    `rotation_other` (default `other`), then transpose/extract, +Q/8 and
    the MKM switch against `other`."""
    params, key, acc, a = _case(param_set)
    p = params.lwe
    tparams, tkey = convert.params_from(params), convert.key_from(key)
    assert TorchBackend._is_two_limb_set(tparams) == (param_set in TWO_LIMB)
    be = TorchBackend("cpu")
    got = be.eval_acc(tparams, tkey, acc.copy(), a, p.q)
    want = np.asarray((rotation_other or other).eval_acc(params, key, acc.copy(), a, p.q),
                      dtype=np.uint64)
    assert got.dtype == np.uint64 and np.array_equal(got, want)
    a_t = poly_transpose(want[:, 0, :], p.Q)
    b = (want[:, 1, 0] + np.uint64(p.Q // 8 + 1)) % np.uint64(p.Q)
    got_ct = be.mkm_switch(tparams, tkey, a_t, b, p.q)
    want_ct = other.mkm_switch(params, key, a_t, b, p.q)
    assert np.array_equal(got_ct.a, np.asarray(want_ct.a))
    assert np.array_equal(got_ct.b, np.asarray(want_ct.b))


@pytest.mark.parametrize("param_set", list(ParamSet), ids=lambda s: s.name)
def test_classic_set_matches_oracle(param_set):
    _compare(param_set, RefBackend())


@pytest.mark.parametrize("param_set", [ParamSet.STD128Q, ParamSet.STD192],
                         ids=lambda s: s.name)
def test_two_limb_set_matches_jax_backend(param_set):
    """STD128Q: rotation and key switch against JaxBackend. STD192: the key
    switch (baseKS 28, not a power of two) against JaxBackend, the rotation
    against the oracle, as test_classic_set_matches_oracle holds it; the
    64-bit rotation at d2 = 6 is held to the JAX package's by
    tests/test_torch_rotate64.py."""
    if param_set == ParamSet.STD128Q:
        _compare(param_set, JaxBackend())
    else:
        _compare(param_set, JaxBackend(), rotation_other=RefBackend())


@pytest.mark.parametrize("param_set", list(ParamSet), ids=lambda s: s.name)
def test_classic_set_ap_matches_jax(param_set):
    """AP on every classic row: TorchBackend takes exactly the sets
    JaxBackend takes (Q and qKS below 2^31, the DM table under its size
    guard, at the full LWE dimension). A taken set, its LWE dimension cut to
    12, matches the host oracle's eval_acc on two accumulators; the others
    raise NotImplementedError in setup."""
    params = torch_params.from_param_set(torch_params.ParamSet(int(param_set)),
                                         torch_params.Method.AP)
    be = TorchBackend("cpu")
    assert be.supports(params) == JaxBackend().supports(
        params_mod.from_param_set(param_set, Method.AP))
    if not be.supports(params):
        with pytest.raises(NotImplementedError):
            be.setup(params, None)
        return
    jparams = _mini_params(param_set, Method.AP)
    p = jparams.lwe
    rng = BinFHERng(2000 + int(param_set))
    key = jax_scheme.key_gen(rng, jparams, lwe.key_gen(rng, p.n, p.q_ks))
    nprng = np.random.default_rng(int(param_set))
    acc = nprng.integers(0, p.Q, (2, 2, p.N)).astype(np.uint64)
    a = nprng.integers(0, p.q, (2, p.n)).astype(np.uint64)
    got = be.eval_acc(convert.params_from(jparams), convert.key_from(key), acc.copy(), a, p.q)
    assert np.array_equal(got, RefBackend().eval_acc(jparams, key, acc.copy(), a, p.q))


def carry(ct):
    return convert.ciphertext_from(ct)


def assert_same(want, got):
    assert want.modulus == got.modulus
    assert np.array_equal(np.asarray(want.a), np.asarray(got.a))
    assert np.array_equal(np.asarray(want.b), np.asarray(got.b))


def port_context(jc, keys):
    """The port's context (device "cpu") on a JAX context's parameters and
    keys, the default gadget base's key loaded last."""
    tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    tc.params = convert.params_from(jc.params)
    tc._time_optimization = jc.params.time_optimization
    default = jc.params.rgsw.base_g
    for base in sorted(keys, key=lambda b: b == default):
        tc.bt_key_load(convert.key_from(keys[base]))
    return tc


def test_two_limb_nand_truth_table_matches_jax_scheme():
    """STD128Q (Q of 50 bits) with n = 12: the gate reaches
    bootstrap_pipeline with the scheme's host test polynomial."""
    jc = JaxContext(seed=31)
    jc.params = _mini_params(ParamSet.STD128Q)
    sk = jc.key_gen()
    jc.bt_key_gen(sk)
    tc = port_context(jc, jc.bt_key_map)
    m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    ct1, ct2 = jc.encrypt(sk, m1), jc.encrypt(sk, m2)
    want = jax_scheme.eval_bin_gate(RefBackend(), jc.params, Gate.NAND, jc.bt_key, ct1, ct2)
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate.NAND, carry(ct1), carry(ct2))
    assert tc.backend._path(tc.params) == "two_limb"
    assert_same(want, got)
    assert np.array_equal(jc.decrypt(sk, got), 1 - (m1 & m2))


@pytest.fixture(scope="module")
def toy_prime():
    """The accelerated TOY sets with the reference's single 54-bit prime
    (rns_modulus=False): the sign context (logQ 17, bases {2^18, 2^27}, one
    digit thrown) and the EvalFunc context (logQ 12, arbFunc), which shares
    its ring secret and switching key."""
    sign = JaxContext(seed=32)
    sign.generate_binfhe_context(ParamSet.TOY, arb_func=False, log_q=17,
                                 num_digits_to_throw=1, time_optimization=True,
                                 rns_modulus=False)
    sk = sign.key_gen()
    sign.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    func = JaxContext(seed=33)
    func.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12,
                                 num_digits_to_throw=1, rns_modulus=False)
    func.bt_key_gen(sk, sk_n=sign.bt_key.sk_n, ksk=sign.bt_key.ksk)
    assert sign.params.rgsw.rns_primes is None and sign.params.lwe.Q > (1 << 53)
    return sign, func, sk


def test_toy_single_prime_sign_matches_jax_scheme(toy_prime):
    jc, _, sk = toy_prime
    tc = port_context(jc, jc.bt_key_map)
    Q_enc = 1 << 17
    P = jc.params.max_plaintext_space * (Q_enc // jc.params.lwe.q)
    delta = np.array([-1, 0])
    ct = jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc)
    want = jc.eval_sign(ct)                          # the host oracle
    got = tc.eval_sign(carry(ct))
    assert not tc.backend.chain_supported(tc.params, tc.bt_key)
    assert_same(want, got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))


def test_toy_single_prime_func_matches_jax_scheme(toy_prime):
    """An arbitrary (not negacyclic) LUT: two bootstraps on the host route."""
    _, jc, sk = toy_prime
    tc = port_context(jc, jc.bt_key_map)
    p = jc.get_max_plaintext_space()
    lut = jc.generate_lut_via_function(lambda m, p1: (m * m * m) % p1, p)
    m = np.array([1, p - 1])
    ct = jc.encrypt(sk, m, "FRESH", p)
    want = jc.eval_func(ct, lut)
    got = tc.eval_func(carry(ct), lut)
    assert tc.backend.func_bootstrap(tc.params, tc.bt_key, lut, carry(ct), p) is None
    assert_same(want, got)
    assert np.array_equal(np.asarray(jc.decrypt(sk, got, p), dtype=np.int64), m ** 3 % p)
