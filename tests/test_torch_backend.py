"""TorchBackend (on the CPU, so the blind rotation takes its plain version)
against the host oracle RefBackend and the JAX backend with the Pallas
kernel, exactly, on identical keys and ciphertexts at TOY."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext, Gate, Method, ParamSet
from tfhe_tpu import params as params_mod
from tfhe_tpu import scheme
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.ref.backend import RefBackend
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend

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
def backends(toy):
    cc = toy[0]
    torch_be = TorchBackend("cpu")
    torch_be.setup(cc.params, cc.bt_key)
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
def test_gate_matches_oracle_and_pallas(toy, backends, gate):
    cc, sk, m1, m2, ct1, ct2 = toy
    torch_be, jax_be = backends
    got = scheme.eval_bin_gate(torch_be, cc.params, gate, cc.bt_key, ct1, ct2)
    assert np.array_equal(cc.decrypt(sk, got), TRUTH[gate](m1, m2))
    assert_same(got, scheme.eval_bin_gate(RefBackend(), cc.params, gate,
                                          cc.bt_key, ct1, ct2))
    assert_same(got, scheme.eval_bin_gate(jax_be, cc.params, gate, cc.bt_key,
                                          ct1, ct2))


def test_bootstrap_matches_oracle_and_pallas(toy, backends):
    cc, sk, m1, _, ct1, _ = toy
    torch_be, jax_be = backends
    got = scheme.bootstrap(torch_be, cc.params, cc.bt_key, ct1)
    assert np.array_equal(cc.decrypt(sk, got), m1)
    assert_same(got, scheme.bootstrap(RefBackend(), cc.params, cc.bt_key, ct1))
    assert_same(got, scheme.bootstrap(jax_be, cc.params, cc.bt_key, ct1))


def test_gate_takes_the_fused_path(toy, backends):
    cc, _, _, _, ct1, ct2 = toy
    q = cc.params.lwe.q
    out = backends[0].gate_bootstrap_pair(cc.params, cc.bt_key, Gate.NAND,
                                          ct1, ct2, False, q)
    assert out is not None and out.a.dtype == np.uint16
    # a result modulus other than q leaves the gate to the generic path
    assert backends[0].gate_bootstrap_pair(cc.params, cc.bt_key, Gate.NAND,
                                           ct1, ct2, False, q // 2) is None


def test_eval_acc_and_mkm_switch_match_oracle(toy, backends):
    cc = toy[0]
    p = cc.params.lwe
    rng = np.random.default_rng(11)
    acc = rng.integers(0, p.Q, (3, 2, p.N)).astype(np.uint64)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.uint64)
    got = backends[0].eval_acc(cc.params, cc.bt_key, acc.copy(), a, p.q)
    assert np.array_equal(got, RefBackend().eval_acc(cc.params, cc.bt_key,
                                                     acc.copy(), a, p.q))
    a_ext = rng.integers(0, p.Q, (3, p.N)).astype(np.uint64)
    b_ext = rng.integers(0, p.Q, 3).astype(np.uint64)
    assert_same(backends[0].mkm_switch(cc.params, cc.bt_key, a_ext, b_ext, p.q),
                RefBackend().mkm_switch(cc.params, cc.bt_key, a_ext, b_ext, p.q))


@pytest.mark.parametrize("q,N", [(512, 256), (1024, 1024), (1024, 128)],
                         ids=["q-divides-2N", "std128", "q-above-2N"])
def test_scaled_indices_match_jax(q, N):
    a = np.random.default_rng(12).integers(0, q, 64).astype(np.uint64)
    a[:3] = [0, 1, q - 1]
    got = TorchBackend._scaled_indices(torch.from_numpy(a.astype(np.int64)), q, N)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), JaxBackend._scaled_indices(a, q, N))


@pytest.mark.parametrize("params", [
    params_mod.from_gpu_style(ParamSet.TOY, True, 12),   # 54-bit Q, qKS 2^35
    params_mod.from_gpu_style(ParamSet.TOY, False, 11),  # 27-bit Q, qKS 2^35
    params_mod.from_param_set(ParamSet.TOY, Method.AP),
    params_mod.from_param_set(ParamSet.STD192),
], ids=["accelerated-logQ12", "accelerated-logQ11", "toy-AP", "std192"])
def test_unsupported_params_raise(params):
    be = TorchBackend("cpu")
    assert not be.supports(params)
    with pytest.raises(NotImplementedError):
        be.setup(params, None)


def test_supported_sets():
    for ps in (ParamSet.TOY, ParamSet.STD128, ParamSet.STD128_OPT, ParamSet.MEDIUM):
        assert TorchBackend.supports(params_mod.from_param_set(ps)), ps


def test_context_device_setup_refuses_unsupported():
    cc = tfhe_tpu_torch.BinFHEContext(seed=1)
    cc.generate_binfhe_context(ParamSet.TOY, arb_func=True, log_q=12)
    cc.bt_key_load(scheme.BTKey(bsk_coeff=np.zeros(1), ksk=None,
                                base_g=cc.params.rgsw.base_g))
    with pytest.raises(NotImplementedError):
        cc.device_setup("cpu")


def test_context_device_setup_runs_gates(toy):
    cc0, sk, m1, m2, ct1, ct2 = toy
    cc = tfhe_tpu_torch.BinFHEContext(seed=1)
    cc.params = cc0.params
    cc.bt_key_load(cc0.bt_key)
    cc.device_setup("cpu")
    out = cc.eval_bin_gate(Gate.AND, ct1, ct2)
    assert np.array_equal(cc0.decrypt(sk, out), m1 & m2)
    with pytest.raises(NotImplementedError):
        cc.ciphertext_mul_matrix(ct1, np.eye(8, dtype=np.int64), 512)


def test_cuda_backend_needs_a_card():
    if torch.cuda.is_available():
        assert TorchBackend("cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchBackend("cuda")


def test_port_never_imports_jax():
    """The port alone, in a fresh interpreter (this process has jax loaded
    by conftest): a TOY NAND on the CPU, and no jax module afterwards."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import tfhe_tpu_torch
        from tfhe_tpu_torch import BinFHEContext, Gate, ParamSet
        cc = BinFHEContext(seed=5)
        cc.generate_binfhe_context(ParamSet.TOY)
        sk = cc.key_gen()
        cc.bt_key_gen(sk)
        m1, m2 = np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1])
        ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
        cc.device_setup("cpu")
        out = cc.eval_bin_gate(Gate.NAND, ct1, ct2)
        assert np.array_equal(cc.decrypt(sk, out), 1 - (m1 & m2))
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
