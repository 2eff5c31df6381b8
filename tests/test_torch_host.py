"""The port's own host layers (copies of the JAX package's parameters, keygen,
encryption, host oracle and host CiphertextMulMatrix) against the originals,
exactly: the same seed gives the same keys and ciphertexts bit for bit, and
the carry-across functions of `tfhe_tpu_torch.convert` reproduce the JAX
package's objects in the port's types."""

import numpy as np
import pytest

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import params as jax_params
from tfhe_tpu import scheme as jax_scheme
from tfhe_tpu.ops import lweops as jax_lweops
from tfhe_tpu.ref.backend import RefBackend as JaxRefBackend
import tfhe_tpu_torch
from tfhe_tpu_torch import convert, lwe, params
from tfhe_tpu_torch.ops import lweops
from tfhe_tpu_torch.ref.backend import RefBackend
from torch_threads import one_torch_thread  # noqa: F401


def same_params(a, b):
    for f in ("n", "N", "q", "Q", "q_ks", "std", "base_ks", "digit_count_ks"):
        assert getattr(a.lwe, f) == getattr(b.lwe, f), f
    for f in ("N", "Q", "q", "base_g", "base_r", "std", "sign_eval",
              "num_digits_to_throw", "digits_g", "root", "g_power_map",
              "digits_r", "rns_primes", "digits_g2"):
        assert getattr(a.rgsw, f) == getattr(b.rgsw, f), f
    assert int(a.rgsw.method) == int(b.rgsw.method)
    assert a.time_optimization == b.time_optimization
    assert (a.beta, a.max_plaintext_space) == (b.beta, b.max_plaintext_space)


@pytest.mark.parametrize("ps", list(params.ParamSet), ids=lambda p: p.name)
def test_classic_params_match(ps):
    same_params(params.from_param_set(ps),
                jax_params.from_param_set(jax_params.ParamSet(int(ps))))


@pytest.mark.parametrize("log_q,arb_func,time_opt", [
    (11, False, False), (12, True, False), (17, False, True), (23, False, True)])
def test_accelerated_params_match(log_q, arb_func, time_opt):
    for ps in (params.ParamSet.TOY, params.ParamSet.STD128):
        got = params.from_gpu_style(ps, arb_func, log_q, time_optimization=time_opt,
                                    num_digits_to_throw=1)
        want = jax_params.from_gpu_style(jax_params.ParamSet(int(ps)), arb_func,
                                         log_q, time_optimization=time_opt,
                                         num_digits_to_throw=1)
        same_params(got, want)
        same_params(convert.params_from(want), want)


def contexts(seed, **gen):
    """A JAX-package context and a port context with the same seed and
    parameters, keys generated in the same order."""
    out = []
    for cls in (JaxContext, tfhe_tpu_torch.BinFHEContext):
        cc = cls(seed=seed)
        cc.generate_binfhe_context("TOY", **gen)
        sk = cc.key_gen()
        cc.bt_key_gen(sk)
        out.append((cc, sk))
    return out


def same_keys(jk, tk):
    assert np.array_equal(jk.bsk_coeff, tk.bsk_coeff)
    assert np.array_equal(jk.ksk.A, tk.ksk.A)
    assert np.array_equal(jk.ksk.B, tk.ksk.B)
    assert np.array_equal(jk.sk_n.s, tk.sk_n.s) and jk.sk_n.modulus == tk.sk_n.modulus


@pytest.mark.parametrize("gen", [{}, {"arb_func": True, "log_q": 12,
                                      "num_digits_to_throw": 1}],
                         ids=["toy", "toy-accelerated-logQ12"])
def test_keygen_and_encrypt_match(gen):
    (jc, jsk), (tc, tsk) = contexts(77, **gen)
    assert np.array_equal(jsk.s, tsk.s) and jsk.modulus == tsk.modulus
    same_keys(jc.bt_key, tc.bt_key)
    same_keys(jc.bt_key, convert.key_from(jc.bt_key))
    m = np.array([0, 1, 1, 0, 1])
    jct, tct = jc.encrypt(jsk, m), tc.encrypt(tsk, m)
    assert np.array_equal(jct.a, tct.a) and np.array_equal(jct.b, tct.b)
    assert jct.modulus == tct.modulus
    carried = convert.ciphertext_from(jct)
    assert isinstance(carried, lwe.LWECiphertext)
    assert np.array_equal(carried.a, tct.a) and np.array_equal(carried.b, tct.b)
    assert np.array_equal(tc.decrypt(tsk, tct), m)


def test_time_optimization_keygen_matches():
    """The multi-base map of EvalSign shares one ring secret and switching
    key: same keys per base in both packages."""
    gen = {"arb_func": False, "log_q": 17, "num_digits_to_throw": 1,
           "time_optimization": True}
    out = []
    for cls in (JaxContext, tfhe_tpu_torch.BinFHEContext):
        cc = cls(seed=5)
        cc.generate_binfhe_context("TOY", **gen)
        cc.bt_key_gen(cc.key_gen(), bases={1 << 18, 1 << 27})
        out.append(cc)
    (jc, tc) = out
    assert sorted(jc.bt_key_map) == sorted(tc.bt_key_map) == [1 << 18, 1 << 27]
    for base in jc.bt_key_map:
        same_keys(jc.bt_key_map[base], tc.bt_key_map[base])
    assert tc.bt_key_map[1 << 18].ksk is tc.bt_key_map[1 << 27].ksk


def test_ref_backend_nand_matches():
    (jc, jsk), (tc, tsk) = contexts(78)
    m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    jct1, jct2 = jc.encrypt(jsk, m1), jc.encrypt(jsk, m2)
    tct1, tct2 = tc.encrypt(tsk, m1), tc.encrypt(tsk, m2)
    want = jax_scheme.eval_bin_gate(JaxRefBackend(), jc.params,
                                    jax_params.Gate.NAND, jc.bt_key, jct1, jct2)
    tc.device_clean()
    got = tc.eval_bin_gate(params.Gate.NAND, tct1, tct2)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
    assert np.array_equal(tc.decrypt(tsk, got), 1 - (m1 & m2))


def test_ciphertext_mul_matrix_matches_and_needs_the_oracle():
    rng = np.random.default_rng(3)
    K, n, M, mod = 6, 10, 4, (1 << 35) + 3
    cts = lwe.LWECiphertext(rng.integers(0, mod, (K, n)).astype(np.uint64),
                            rng.integers(0, mod, K).astype(np.uint64), mod)
    mat = rng.integers(-1000, 1000, (K, M))
    want = jax_lweops.ciphertext_mul_matrix(cts, mat, mod)
    got = lweops.ciphertext_mul_matrix(cts, mat, mod)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)
    cc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    out = cc.ciphertext_mul_matrix(cts, mat, mod)      # the torch device product
    assert np.array_equal(out.a, want.a) and np.array_equal(out.b, want.b)
    cc.use_backend(RefBackend())
    out = cc.ciphertext_mul_matrix(cts, mat, mod)
    assert np.array_equal(out.a, want.a)


def test_seeded_toy_context_round_trips(tmp_path):
    """At the accelerated TOY set a seeded keygen on the CPU gives a
    `SeededSwitchingKey` whose rows, regenerated from its seed, encrypt
    s_N[i] * v * baseKS^j under the LWE secret with small noise; `save` and
    `load` round-trip the context with the key still seeded (its seed,
    dimensions and B, the A block never materialized), the bootstrapping
    key, the key map and the parameters equal."""
    cc = tfhe_tpu_torch.BinFHEContext(seed=1, seeded_ksk=True, device="cpu")
    cc.generate_binfhe_context(params.ParamSet.TOY, arb_func=True, log_q=12)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    ksk, p = cc.bt_key.ksk, cc.params.lwe
    assert isinstance(ksk, lwe.SeededSwitchingKey)
    assert ksk.B.shape == (p.N, p.base_ks, p.digit_count_ks)
    R = ksk.rows
    for r0 in (0, lwe.KSK_ROW_CHUNK - 4, R - 8):
        a = lwe.seeded_rows(ksk.seed, p.n, p.q_ks, r0, r0 + 8, "cpu").numpy()
        i, rest = np.divmod(np.arange(r0, r0 + 8), p.base_ks * p.digit_count_ks)
        v, j = np.divmod(rest, p.digit_count_ks)
        msg = cc.bt_key.sk_n.s[i] * v * p.base_ks ** j
        e = (ksk.B.reshape(-1)[r0:r0 + 8].astype(np.int64) - a @ sk.s - msg) % p.q_ks
        e = np.where(e > p.q_ks // 2, e - p.q_ks, e)
        assert np.abs(e).max() <= 40 and np.abs(a).max() < p.q_ks
    path = str(tmp_path / "toy_seeded.npz")
    cc.save(path)
    cc2 = tfhe_tpu_torch.BinFHEContext.load(path, device="cpu")
    assert cc2.device == "cpu" and cc2.params == cc.params
    assert sorted(cc2.bt_key_map) == sorted(cc.bt_key_map)
    for base, key in cc.bt_key_map.items():
        k2 = cc2.bt_key_map[base]
        assert isinstance(k2.ksk, lwe.SeededSwitchingKey) and k2.ksk._A is None
        assert (k2.ksk.seed, k2.ksk.N, k2.ksk.base_ks, k2.ksk.digit_count, k2.ksk.n,
                k2.ksk.q_ks) == (ksk.seed, ksk.N, ksk.base_ks, ksk.digit_count, ksk.n,
                                 ksk.q_ks)
        assert np.array_equal(k2.ksk.B, ksk.B) and np.array_equal(k2.bsk_coeff, key.bsk_coeff)
    assert ksk._A is None
