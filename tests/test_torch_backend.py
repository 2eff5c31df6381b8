"""TorchBackend (on the CPU, so the blind rotation takes its plain version)
under the port's own scheme, against the JAX package's host oracle
RefBackend and its JAX backend with the Pallas kernel, exactly, on
identical keys and ciphertexts at TOY: the JAX package's keys and
ciphertexts are carried into the port's types with `tfhe_tpu_torch.convert`."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext, Gate, ParamSet
from tfhe_tpu import scheme
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.ref.backend import RefBackend
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch import params as params_mod
from tfhe_tpu_torch import scheme as torch_scheme
from tfhe_tpu_torch.ops.lweops import ciphertext_mul_matrix
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


@pytest.fixture(scope="module")
def toy():
    cc = BinFHEContext(seed=2718)
    cc.generate_binfhe_context(ParamSet.TOY)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    m1 = np.array([0, 0, 1, 1, 0, 1, 1, 0])
    m2 = np.array([0, 1, 0, 1, 1, 1, 0, 0])
    return cc, sk, m1, m2, cc.encrypt(sk, m1), cc.encrypt(sk, m2)


@pytest.fixture(scope="module")
def port(toy):
    """The TOY context's parameters, key and ciphertexts in the port's types."""
    cc, _, _, _, ct1, ct2 = toy
    return (convert.params_from(cc.params), convert.key_from(cc.bt_key),
            convert.ciphertext_from(ct1), convert.ciphertext_from(ct2))


@pytest.fixture(scope="module")
def backends(toy, port):
    cc = toy[0]
    torch_be = TorchBackend("cpu")
    torch_be.setup(*port[:2])
    jax_be = JaxBackend()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFHE_TPU_PALLAS", "1")
        assert jax_be._use_pallas(cc.params)
        jax_be.setup(cc.params, cc.bt_key)
    return torch_be, jax_be


def assert_same(x, y):
    assert np.array_equal(np.asarray(x.a), np.asarray(y.a))
    assert np.array_equal(np.asarray(x.b), np.asarray(y.b))
    assert x.modulus == y.modulus


@pytest.mark.parametrize("gate", list(Gate), ids=lambda g: g.name)
def test_gate_matches_oracle_and_pallas(toy, port, backends, gate):
    cc, sk, m1, m2, ct1, ct2 = toy
    params, key, tct1, tct2 = port
    torch_be, jax_be = backends
    got = torch_scheme.eval_bin_gate(torch_be, params, params_mod.Gate(int(gate)),
                                     key, tct1, tct2)
    assert np.array_equal(cc.decrypt(sk, got), TRUTH[gate](m1, m2))
    assert_same(got, scheme.eval_bin_gate(RefBackend(), cc.params, gate,
                                          cc.bt_key, ct1, ct2))
    assert_same(got, scheme.eval_bin_gate(jax_be, cc.params, gate, cc.bt_key,
                                          ct1, ct2))


def test_bootstrap_matches_oracle_and_pallas(toy, port, backends):
    cc, sk, m1, _, ct1, _ = toy
    params, key, tct1, _ = port
    torch_be, jax_be = backends
    got = torch_scheme.bootstrap(torch_be, params, key, tct1)
    assert np.array_equal(cc.decrypt(sk, got), m1)
    assert_same(got, scheme.bootstrap(RefBackend(), cc.params, cc.bt_key, ct1))
    assert_same(got, scheme.bootstrap(jax_be, cc.params, cc.bt_key, ct1))


def test_gate_takes_the_fused_path(port, backends):
    params, key, ct1, ct2 = port
    q = params.lwe.q
    out = backends[0].gate_bootstrap_pair(params, key, params_mod.Gate.NAND,
                                          ct1, ct2, False, q)
    assert out is not None and out.a.dtype == np.uint16
    # a result modulus other than q leaves the gate to the generic path
    assert backends[0].gate_bootstrap_pair(params, key, params_mod.Gate.NAND,
                                           ct1, ct2, False, q // 2) is None


def test_eval_acc_and_mkm_switch_match_oracle(toy, port, backends):
    cc = toy[0]
    params, key = port[:2]
    p = cc.params.lwe
    rng = np.random.default_rng(11)
    acc = rng.integers(0, p.Q, (3, 2, p.N)).astype(np.uint64)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.uint64)
    got = backends[0].eval_acc(params, key, acc.copy(), a, p.q)
    assert np.array_equal(got, RefBackend().eval_acc(cc.params, cc.bt_key,
                                                     acc.copy(), a, p.q))
    a_ext = rng.integers(0, p.Q, (3, p.N)).astype(np.uint64)
    b_ext = rng.integers(0, p.Q, 3).astype(np.uint64)
    assert_same(backends[0].mkm_switch(params, key, a_ext, b_ext, p.q),
                RefBackend().mkm_switch(cc.params, cc.bt_key, a_ext, b_ext, p.q))


@pytest.mark.parametrize("q,N", [(512, 256), (1024, 1024), (1024, 128)],
                         ids=["q-divides-2N", "std128", "q-above-2N"])
def test_scaled_indices_match_jax(q, N):
    a = np.random.default_rng(12).integers(0, q, 64).astype(np.uint64)
    a[:3] = [0, 1, q - 1]
    got = TorchBackend._scaled_indices(torch.from_numpy(a.astype(np.int64)), q, N)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), JaxBackend._scaled_indices(a, q, N))


@pytest.mark.parametrize("param_set", [params_mod.ParamSet.TOY, params_mod.ParamSet.STD128],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("log_q,arb,path", [(11, False, "mixed"), (12, True, "rns"),
                                            (17, False, "rns"), (23, False, "rns")],
                         ids=["logQ11-N4096", "logQ12-N4096", "logQ17-N4096", "logQ23-N4096"])
def test_ring4096_params_are_supported(param_set, log_q, arb, path):
    """N = 4096 with the composite modulus: logQ = 11 on the mixed path
    (blind_rotate), the accelerated sets on the RNS path (the cluster
    layout of blind_rotate_rns)."""
    params = params_mod.from_gpu_style(param_set, arb, log_q, N=4096)
    assert params.rgsw.N == 4096
    assert TorchBackend.supports(params) and TorchBackend._path(params) == path


@pytest.mark.parametrize("param_set", [params_mod.ParamSet.TOY, params_mod.ParamSet.STD128],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("log_q,arb", [(12, True), (17, False), (23, False)],
                         ids=["logQ12-N8192", "logQ17-N8192", "logQ23-N8192"])
def test_ring8192_rns_params_are_supported(param_set, log_q, arb):
    """N = 8192 with the composite modulus: the accelerated sets on the RNS
    path (blind_rotate_rns as a cluster of four blocks)."""
    params = params_mod.from_gpu_style(param_set, arb, log_q, N=8192)
    assert params.rgsw.N == 8192 and params.rgsw.rns_primes == (133857281, 133644289)
    assert TorchBackend.supports(params) and TorchBackend._path(params) == "rns"


@pytest.mark.parametrize("param_set", [params_mod.ParamSet.TOY, params_mod.ParamSet.STD128],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("log_q,arb", [(12, True), (17, False), (23, False)],
                         ids=["logQ12-N16384", "logQ17-N16384", "logQ23-N16384"])
def test_ring16384_rns_params_are_supported(param_set, log_q, arb):
    """N = 16384: the accelerated sets with Q = q1*q2 on the RNS path
    (blind_rotate_rns as a cluster of eight blocks)."""
    params = params_mod.from_gpu_style(param_set, arb, log_q, N=16384)
    assert params.rgsw.N == 16384 and params.rgsw.rns_primes == (133857281, 132710401)
    assert TorchBackend.supports(params) and TorchBackend._path(params) == "rns"


@pytest.mark.parametrize("param_set", [params_mod.ParamSet.TOY, params_mod.ParamSet.STD128],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("log_q,arb", [(12, True), (17, False), (23, False)],
                         ids=["logQ12-N8192", "logQ17-N8192", "logQ23-N8192"])
def test_ring8192_two_limb_params_are_supported(param_set, log_q, arb):
    """N = 8192 at the reference's single 54-bit prime: the accelerated
    sets on the two-limb path (blind_rotate64 as a cluster of four
    blocks)."""
    params = params_mod.from_gpu_style(param_set, arb, log_q, N=8192, rns_modulus=False)
    assert params.rgsw.N == 8192 and params.rgsw.rns_primes is None
    assert params.lwe.Q == 18014398508400641          # ntt_prime(54, 16384)
    assert TorchBackend.supports(params) and TorchBackend._path(params) == "two_limb"


@pytest.mark.parametrize("params", [
    params_mod.from_param_set(params_mod.ParamSet.STD192, params_mod.Method.AP),
    params_mod.from_gpu_style(params_mod.ParamSet.TOY, False, 17, N=16384,
                              rns_modulus=False),                         # two-limb, N = 16384
    params_mod.from_gpu_style(params_mod.ParamSet.TOY, True, 12, N=32768),  # RNS, N = 32768
    params_mod.from_param_set(params_mod.ParamSet.STD128Q, params_mod.Method.AP),
], ids=["std192-AP", "two-limb-N16384", "logQ12-N32768", "std128q-AP"])
def test_unsupported_params_raise(params):
    be = TorchBackend("cpu")
    assert not be.supports(params)
    with pytest.raises(NotImplementedError):
        be.setup(params, None)


def test_supported_sets():
    """Every GINX row of the classic table (the single-limb gate sets and
    the 8 two-limb sets), and the accelerated maps with either ring
    modulus: Q = q1*q2 (RNS) or the reference's single 54-bit prime."""
    P = params_mod.ParamSet
    two_limb = (P.STD192, P.STD192_OPT, P.STD256, P.STD256_OPT, P.STD128Q,
                P.STD128Q_OPT, P.STD192Q, P.STD192Q_OPT)
    for ps in P:
        params = params_mod.from_param_set(ps)
        assert TorchBackend.supports(params), ps
        assert TorchBackend._is_two_limb_set(params) == (ps in two_limb), ps
    for rns in (None, False):
        for log_q, arb, to in ((12, True, False), (17, False, True), (23, False, True)):
            acc = params_mod.from_gpu_style(P.STD128, arb, log_q, time_optimization=to,
                                            num_digits_to_throw=1, rns_modulus=rns)
            assert (acc.rgsw.rns_primes is None) == (rns is False)
            for base in sorted(acc.rgsw.g_power_map):
                acc.rgsw.change_base_g(base)
                assert TorchBackend.supports(acc), (rns, log_q, base)
                assert TorchBackend._is_two_limb_set(acc) == (rns is False)


def test_context_device_setup_refuses_unsupported():
    """A ring dimension the kernels do not take (N = 16384 on the mixed
    path) raises in setup, never on the card, and never runs on the
    oracle."""
    cc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    cc.generate_binfhe_context(params_mod.ParamSet.TOY, arb_func=False, log_q=11, N=16384)
    cc.bt_key_load(torch_scheme.BTKey(bsk_coeff=np.zeros(1), ksk=None,
                                      base_g=cc.params.rgsw.base_g))
    with pytest.raises(NotImplementedError):
        cc.device_setup("cpu")
    with pytest.raises(NotImplementedError):     # also lazily, never the oracle
        cc.eval_bin_gate(params_mod.Gate.AND, None, None)


def test_context_device_setup_runs_gates(toy, port):
    cc0, sk, m1, m2, _, _ = toy
    params, key, ct1, ct2 = port
    cc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    cc.params = params
    cc.bt_key_load(key)
    out = cc.eval_bin_gate(params_mod.Gate.AND, ct1, ct2)
    assert isinstance(cc.backend, TorchBackend) and cc.backend.device.type == "cpu"
    assert np.array_equal(cc0.decrypt(sk, out), m1 & m2)
    mat = np.random.default_rng(13).integers(-9, 10, (8, 5))
    got = cc.ciphertext_mul_matrix(ct1, mat, 512)
    want = ciphertext_mul_matrix(ct1, mat, 512)
    assert np.array_equal(got.a, want.a) and np.array_equal(got.b, want.b)


def test_cuda_backend_needs_a_card():
    if torch.cuda.is_available():
        assert TorchBackend("cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchBackend("cuda")


def test_context_evaluates_on_the_card_by_default(port):
    """Without a device argument the context sets up TorchBackend("cuda") at
    its first evaluation; with no card that raises, and nothing runs on the
    host oracle."""
    params, key, ct1, ct2 = port
    cc = tfhe_tpu_torch.BinFHEContext(seed=1)
    assert cc.device == "cuda"
    cc.params = params
    cc.bt_key_load(key)
    if torch.cuda.is_available():
        cc.eval_bin_gate(params_mod.Gate.AND, ct1, ct2)
        assert cc.backend.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            cc.eval_bin_gate(params_mod.Gate.AND, ct1, ct2)
        assert cc._backend is None
    cc.device_clean()
    assert isinstance(cc.backend, tfhe_tpu_torch.ref.backend.RefBackend)


def test_port_never_imports_jax():
    """The port alone, in a fresh interpreter (this process has jax and the
    JAX package loaded): a TOY NAND, a small RNS EvalSign, a seeded TOY
    keygen (`utils.threefry`), a device CKKS multiplication
    (`tfhe_tpu_torch.pke`, `pke.ckks_device`), a weighted sum on the device
    evaluator (`pke.advancedshe_device`, with the CKKS bootstrapping, auto-
    scaling, noise-flooding and BGV modules imported), a BEHZ BFV
    multiplication on the device context from `gen_crypto_context` (with
    the HPS, advanced, parameter-generation and serialization modules
    imported) and a save/load of the seeded TOY context on the CPU, with
    one torch thread as the in-process tests have, and no jax, tfhe_tpu or
    tfhe_tpu.* module afterwards."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(1)   # as the in-process port tests (torch_threads.py)
        import tfhe_tpu_torch
        from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet
        from tfhe_tpu_torch.params import BinFHEParams, LWEParams, Method, RGSWParams
        from tfhe_tpu_torch.utils.numtheory import ntt_prime, previous_prime
        cc = BinFHEContext(seed=5, device="cpu")
        cc.generate_binfhe_context(ParamSet.TOY)
        sk = cc.key_gen()
        cc.bt_key_gen(sk)
        m1, m2 = np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])
        ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
        out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        assert np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2))
        N, q = 256, 512
        q1 = ntt_prime(17, 2 * N); q2 = previous_prime(q1, 2 * N)
        cc = BinFHEContext(seed=6, device="cpu")
        cc.params = BinFHEParams(
            lwe=LWEParams(n=8, N=N, q=q, Q=q1 * q2, q_ks=1 << 35, std=3.19, base_ks=32),
            rgsw=RGSWParams(N=N, Q=q1 * q2, q=q, base_g=1 << 7, base_r=23,
                            method=Method.GINX, std=3.19, sign_eval=True))
        sk = cc.key_gen()
        cc.bt_key_gen(sk)
        P = cc.params.max_plaintext_space * 4
        delta = np.array([-2, -1, 0, 1])
        ct = cc.encrypt(sk, (P // 2 + delta) % P, "FRESH", P, 1 << 11)
        out = cc.eval_sign(ct)
        assert np.array_equal(cc.decrypt(sk, out, 2), (delta >= 0).astype(np.uint64))
        from tfhe_tpu_torch.utils import threefry
        cc = BinFHEContext(seed=7, seeded_ksk=True, device="cpu")
        cc.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12)
        cc.bt_key_gen(cc.key_gen())
        assert isinstance(cc.bt_key.ksk, tfhe_tpu_torch.lwe.SeededSwitchingKey)
        import tfhe_tpu_torch.pke
        from tfhe_tpu_torch.pke import ckks_device
        p = tfhe_tpu_torch.pke.CKKSParams(
            N=32, dcrt=tfhe_tpu_torch.pke.DCRTParams.create(32, 3, 28), scale=float(1 << 28))
        ctx = tfhe_tpu_torch.pke.CKKSContext(p, seed=7)
        csk, cpk = ctx.key_gen()
        rctx = tfhe_tpu_torch.pke.CKKSRnsContext(ctx, dnum=2, ks_limb_bits=28)
        dctx = ckks_device.CKKSDeviceContext(rctx, device="cpu")
        rlk = rctx.relin_key_gen_single(csk)
        dctx.load_relin_keys(rlk)
        z = np.linspace(0.1, 0.9, 16)
        d = dctx.upload(ctx.encrypt(cpk, z))
        assert np.abs(ctx.decrypt(csk, dctx.download(dctx.eval_mult(d, d))) - z * z).max() < 1e-3
        from tfhe_tpu_torch.pke import (advancedshe, advancedshe_device, bfv, bgv,
                                        bgv_auto, bgv_device, bgv_rns, ckks_auto,
                                        ckks_auto_device, ckks_boot, ckks_boot_device,
                                        ckks_boot_fft, ckks_boot_fft_device,
                                        noise_flooding)
        ev = ckks_boot_device.CKKSDeviceEvaluator(rctx, device="cpu")
        ev.load_keys(rlk, {})
        w = advancedshe_device.eval_linear_wsum(ev, [d, d], [0.5, -2.0])
        assert np.abs(ctx.decrypt(csk, ev.dctx.download(w)) + 1.5 * z).max() < 1e-3
        from tfhe_tpu_torch.pke import (advanced, bfv_behz, bfv_behz_device, bfv_device,
                                        bfv_rns, context, parametergen, serial)
        from tfhe_tpu_torch.utils import serial as binfhe_serial
        bc = tfhe_tpu_torch.pke.gen_crypto_context(
            "BFV", N=32, plaintext_modulus=257, mult_depth=1, limb_bits=28,
            multiplication_technique="behz", seed=7)
        bsk, bpk = bc.key_gen()
        bd = bfv_behz_device.BFVBehzDeviceContext(bc, device="cpu")
        bd.load_relin_key(bc.relin_key_gen(bsk))
        v = np.arange(32) % 257
        x = bd.upload(bc.encrypt_packed(bpk, v))
        assert np.array_equal(bc.decrypt_packed(bsk, bd.download(bd.eval_mult(x, x))),
                              v * v % 257)
        import os, tempfile
        with tempfile.TemporaryDirectory() as tmp:
            cc.save(os.path.join(tmp, "ctx.npz"))
            cc2 = BinFHEContext.load(os.path.join(tmp, "ctx.npz"), device="cpu")
        assert cc2.bt_key.ksk.seed == cc.bt_key.ksk.seed
        bad = [m for m in sys.modules if m in ("jax", "tfhe_tpu")
               or m.startswith(("jax.", "tfhe_tpu."))]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
