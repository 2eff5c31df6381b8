"""The port's RNS functional slice end to end: `TorchBackend("cpu")` (the
plain versions of the kernels) under the port's own context and scheme,
against the JAX package's scheme with its host oracle `RefBackend`, bit for
bit, on the same keys and ciphertexts.

The ring is the `ctx_rns` scale of tests/test_jax_backend.py: Q = q1*q2 of
two 17-bit primes, N = 256, n = 8, qKS = 2^35, baseKS = 32. One more case
runs the accelerated TOY set (N = 2048, 27-bit primes) with the two-base
time-optimization map of EvalSign."""

import numpy as np
import pytest

from tfhe_tpu import BinFHEContext as JaxContext
from tfhe_tpu import scheme as jax_scheme
from tfhe_tpu.params import BinFHEParams, LWEParams, Method, RGSWParams
from tfhe_tpu.ref.backend import RefBackend as JaxRefBackend
from tfhe_tpu.utils.numtheory import ntt_prime, previous_prime
import tfhe_tpu_torch
from tfhe_tpu_torch import convert, scheme
from tfhe_tpu_torch.ops import backend as torch_backend
from torch_threads import one_torch_thread  # noqa: F401


def make_pair(q: int, seed: int):
    """A JAX-package context and the port's context (device "cpu") on the
    same composite-Q parameters, with identical keys from one seed."""
    N = 256
    q1 = ntt_prime(17, 2 * N)
    q2 = previous_prime(q1, 2 * N)
    params = BinFHEParams(
        lwe=LWEParams(n=8, N=N, q=q, Q=q1 * q2, q_ks=1 << 35, std=3.19, base_ks=32),
        rgsw=RGSWParams(N=N, Q=q1 * q2, q=q, base_g=1 << 7, base_r=23,
                        method=Method.GINX, std=3.19, sign_eval=True))
    jc = JaxContext(seed=seed)
    jc.params = params
    tc = tfhe_tpu_torch.BinFHEContext(seed=seed, device="cpu")
    tc.params = convert.params_from(params)
    sk = jc.key_gen()
    jc.bt_key_gen(sk)
    tsk = tc.key_gen()
    tc.bt_key_gen(tsk)
    assert np.array_equal(jc.bt_key.bsk_coeff, tc.bt_key.bsk_coeff)
    assert np.array_equal(jc.bt_key.ksk.A, tc.bt_key.ksk.A)
    return jc, tc, sk


@pytest.fixture(scope="module")
def rns():
    return make_pair(512, 4242)


@pytest.fixture(scope="module")
def rns_func():
    """q = N, as the accelerated EvalFunc sets have (arbFunc)."""
    return make_pair(256, 4243)


def carry(ct):
    return convert.ciphertext_from(ct)


def assert_same(want, got):
    assert want.modulus == got.modulus
    assert np.array_equal(np.asarray(want.a), np.asarray(got.a))
    assert np.array_equal(np.asarray(want.b), np.asarray(got.b))


def sign_input(jc, sk, Q_enc=1 << 11, delta=(-2, -1, 0, 1)):
    q = jc.params.lwe.q
    P = jc.params.max_plaintext_space * (Q_enc // q)
    delta = np.array(delta)
    return jc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, Q_enc), delta


def test_sign_chain_matches_oracle(rns):
    jc, tc, sk = rns
    ct, delta = sign_input(jc, sk)
    keys = {jc.params.rgsw.base_g: jc.bt_key}
    want = jax_scheme.eval_sign(JaxRefBackend(), jc.params, keys, ct, jc.params.beta)
    be = tc.backend
    assert isinstance(be, tfhe_tpu_torch.TorchBackend) and be.device.type == "cpu"
    assert scheme._chain_mods_ok(be, tc.params, tc.bt_key_map,
                                 scheme._mod_schedule(1 << 11, 512, 128), 512)
    got = tc.eval_sign(carry(ct))
    assert_same(want, got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))


def test_decomp_chain_matches_oracle(rns):
    jc, tc, sk = rns
    q, Q_enc = jc.params.lwe.q, 1 << 11
    P = jc.params.max_plaintext_space * (Q_enc // q)
    ct = jc.encrypt(sk, np.array([1, P // 3, P // 2, P - 1]), "FRESH", P, Q_enc)
    keys = {jc.params.rgsw.base_g: jc.bt_key}
    want = jax_scheme.eval_decomp(JaxRefBackend(), jc.params, keys, ct, jc.params.beta)
    got = tc.eval_decomp(carry(ct))
    assert len(want) == len(got) >= 2
    for w, g in zip(want, got):
        assert_same(w, g)


def test_floor_chain_matches_oracle(rns):
    jc, tc, sk = rns
    p = jc.params.max_plaintext_space
    ct = jc.encrypt(sk, np.array([1, p // 3, p // 2, p - 1]), "FRESH", p)
    want = jax_scheme.eval_floor(JaxRefBackend(), jc.params, jc.bt_key, ct,
                                 jc.params.beta, 1)
    assert_same(want, tc.eval_floor(carry(ct), 1))


def lut_of(kind: str, q: int, rng, rows=None):
    shape = (q // 2,) if rows is None else (rows, q // 2)
    half = rng.integers(1, q, shape).astype(np.uint64)
    if kind == "negacyclic":
        other = (q - half) % q
    elif kind == "periodic":
        other = half
    else:
        other = rng.integers(0, q, shape).astype(np.uint64)
        other.reshape(-1, q // 2)[:, 0] = (half.reshape(-1, q // 2)[:, 0] + 1) % q
    return np.concatenate([half, other], axis=-1)


@pytest.mark.parametrize("per_ct", [False, True], ids=["shared", "per-ct"])
@pytest.mark.parametrize("kind", ["negacyclic", "periodic", "arbitrary"])
def test_eval_func_matches_oracle(rns_func, kind, per_ct):
    jc, tc, sk = rns_func
    q, B = jc.params.lwe.q, 4
    rng = np.random.default_rng(len(kind) + 10 * per_ct)
    lut = lut_of(kind, q, rng, B if per_ct else None)
    assert jax_scheme.check_input_function(lut[0] if per_ct else lut, q) == \
        ["negacyclic", "periodic", "arbitrary"].index(kind)
    p = jc.params.max_plaintext_space
    ct = jc.encrypt(sk, rng.integers(0, p, B), "FRESH", p)
    want = jax_scheme.eval_func(JaxRefBackend(), jc.params, jc.bt_key, ct, lut,
                                jc.params.beta, per_ct)
    assert_same(want, tc.eval_func(carry(ct), lut, per_ct))


def test_fast_paths_engage(rns):
    jc, tc, sk = rns
    be, q = tc.backend, tc.params.lwe.q
    assert be.chain_supported(tc.params, tc.bt_key)
    ct, _ = scheme._as_batch(carry(jc.encrypt(sk, np.array([0, 1, 1]))))
    fv = np.arange(q, dtype=np.uint64) % 7
    assert be.func_bootstrap(tc.params, tc.bt_key, fv, ct, q) is not None
    fv2 = np.stack([fv] * 3)
    assert be.func_bootstrap(tc.params, tc.bt_key, fv2, ct, q) is not None
    # gates on the RNS sets take scheme's generic route
    assert be.gate_bootstrap_pair(tc.params, tc.bt_key, tfhe_tpu_torch.Gate.AND,
                                  ct, ct, False, q) is None


def test_func_bootstrap_dev_slices_are_exact(rns, monkeypatch):
    jc, tc, sk = rns
    be, q = tc.backend, tc.params.lwe.q
    ct = carry(jc.encrypt(sk, np.arange(5) % 4))
    fv = np.random.default_rng(2).integers(0, q, (5, q)).astype(np.uint64)
    whole = be.lwe_download(be.func_bootstrap_dev(tc.params, tc.bt_key, fv,
                                                  be.lwe_upload(ct), q, q))
    monkeypatch.setattr(torch_backend, "_FUNC_CHUNK", 2)
    split = be.lwe_download(be.func_bootstrap_dev(tc.params, tc.bt_key, fv,
                                                  be.lwe_upload(ct), q, q))
    assert_same(whole, split)


def test_gate_and_eval_acc_on_rns_match_oracle(rns):
    jc, tc, sk = rns
    m1, m2 = np.array([0, 1, 1, 0]), np.array([1, 1, 0, 0])
    ct1, ct2 = jc.encrypt(sk, m1), jc.encrypt(sk, m2)
    want = jax_scheme.eval_bin_gate(JaxRefBackend(), jc.params, 3, jc.bt_key, ct1, ct2)
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate.NAND, carry(ct1), carry(ct2))
    assert_same(want, got)
    assert np.array_equal(jc.decrypt(sk, got), 1 - (m1 & m2))
    p = jc.params.lwe
    rng = np.random.default_rng(5)
    acc = rng.integers(0, p.Q, (3, 2, p.N)).astype(np.uint64)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.uint64)
    np.testing.assert_array_equal(
        tc.backend.eval_acc(tc.params, tc.bt_key, acc.copy(), a, p.q),
        JaxRefBackend().eval_acc(jc.params, jc.bt_key, acc.copy(), a, p.q))


def test_toy_accelerated_sign_with_two_bases():
    """Accelerated TOY (N = 2048, 27-bit primes), logQ 17 with the
    time-optimization map {2^18, 2^27}: EvalSign switches the gadget base
    under the chain, and each base's device key is its own. The JAX
    package's keys are carried into the port's context, default base last."""
    ctxs = []
    for cls in (JaxContext, tfhe_tpu_torch.BinFHEContext):
        cc = cls(seed=21)
        cc.generate_binfhe_context("TOY", arb_func=False, log_q=17,
                                   num_digits_to_throw=1, time_optimization=True)
        ctxs.append(cc)
    jc, tc = ctxs
    sk = jc.key_gen()
    jc.bt_key_gen(sk, bases={1 << 18, 1 << 27})
    default = jc.params.rgsw.base_g
    for base in sorted(jc.bt_key_map, key=lambda b: b == default):
        tc.bt_key_load(convert.key_from(jc.bt_key_map[base]))
    tc.device_setup("cpu")
    ct, delta = sign_input(jc, sk, 1 << 17, delta=(-1, 0))
    want = jc.eval_sign(ct)
    got = tc.eval_sign(carry(ct))
    assert_same(want, got)
    assert np.array_equal(jc.decrypt(sk, got, 2), (delta >= 0).astype(np.uint64))
    assert len(tc.backend._device_keys) == 2
