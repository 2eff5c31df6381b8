"""The port's DM/AP accumulator (`tfhe_tpu_torch/ops/blindrotate_dm.py` and
TorchBackend's AP branches) on the CPU, against the JAX package's
`tfhe_tpu/ops/blindrotate_dm.py`, its JaxBackend and its host oracle
RefBackend, bit for bit, on the TOY AP keys of tests/test_dm_device.py
(seed 21) carried across with `tfhe_tpu_torch.convert`."""

import numpy as np
import pytest
import torch

from tfhe_tpu import BinFHEContext, Gate, Method, ParamSet
from tfhe_tpu.ops import blindrotate_dm as jax_dm
from tfhe_tpu.ops.backend import JaxBackend
from tfhe_tpu.ref import ntt as jax_ref_ntt
from tfhe_tpu.ref.backend import RefBackend
import tfhe_tpu_torch
from tfhe_tpu_torch import TorchBackend, convert
from tfhe_tpu_torch.ops import blindrotate_dm
from tfhe_tpu_torch.ops.ntt_sched import schedule
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


@pytest.fixture(scope="module")
def ctx():
    cc = BinFHEContext(seed=21)
    cc.generate_binfhe_context(ParamSet.TOY, Method.AP)
    sk = cc.key_gen()
    cc.bt_key_gen(sk)
    return cc, sk


@pytest.fixture(scope="module")
def port(ctx):
    cc = ctx[0]
    return convert.params_from(cc.params), convert.key_from(cc.bt_key)


@pytest.fixture(scope="module")
def table(ctx):
    cc = ctx[0]
    return blindrotate_dm.pack_dm_table(cc.bt_key.bsk_coeff, cc.params.lwe.Q)


def step_inputs(cc, seed: int, B: int = 4):
    """Accumulators and a-vectors; row 0's a is all zero (every digit of
    q - 0 is zero: the accumulator is kept), row 1 holds q - 1."""
    p = cc.params.lwe
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, p.Q, (B, 2, p.N)).astype(np.uint64)
    a = rng.integers(0, p.q, (B, p.n)).astype(np.uint64)
    a[0], a[1, :4] = 0, p.q - 1
    return acc, a


def test_dm_digits_match_jax(ctx):
    cc = ctx[0]
    rg = cc.params.rgsw
    _, a = step_inputs(cc, 0)
    a[2] += np.uint64(3 * cc.params.lwe.q)              # any representative mod q
    got = blindrotate_dm.dm_digits(torch.from_numpy(a.astype(np.int64)), cc.params.lwe.q,
                                   rg.base_r, len(rg.digits_r))
    want = jax_dm.dm_digits(a, cc.params.lwe.q, rg.base_r, len(rg.digits_r))
    assert np.array_equal(got.numpy(), want)


def test_dm_table_matches_jax(ctx, table):
    """The int32 residues equal the JAX package's bf16 7-bit limbs summed,
    point j of the port's table being point bitrev[j] of the JAX one."""
    cc = ctx[0]
    Q, N = cc.params.lwe.Q, cc.params.lwe.N
    bsk_hat = jax_ref_ntt.forward(np.asarray(cc.bt_key.bsk_coeff, dtype=np.uint64), Q)
    limbs = np.asarray(jax_dm.pack_dm_table(bsk_hat, Q), dtype=np.float32)
    L = jax_dm.dm_limbs(Q)
    limbs = limbs.reshape(limbs.shape[0], limbs.shape[1], L, -1).astype(np.int64)
    vals = sum(limbs[:, :, l] << (7 * l) for l in range(L)).reshape(table.shape)
    assert table.dtype == torch.int32
    assert np.array_equal(table.numpy(), vals[..., schedule(N, Q)["bitrev"]])


def test_dm_rotate_matches_jax(ctx, table):
    cc = ctx[0]
    p, rg = cc.params.lwe, cc.params.rgsw
    acc, a = step_inputs(cc, 1)
    digits = jax_dm.dm_digits(a, p.q, rg.base_r, len(rg.digits_r))
    got = blindrotate_dm.dm_rotate(torch.from_numpy(acc.astype(np.int64)),
                                   torch.from_numpy(digits.astype(np.int64)), table,
                                   p.Q, rg.base_g, rg.digits_g)
    bsk_hat = jax_ref_ntt.forward(np.asarray(cc.bt_key.bsk_coeff, dtype=np.uint64), p.Q)
    fn = jax_dm.build_dm_rotate(p.N, p.Q, rg.base_g, rg.digits_g, rg.base_r, digits.shape[1])
    want = np.asarray(fn(acc.astype(np.uint32), digits, jax_dm.pack_dm_table(bsk_hat, p.Q)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(got[0].numpy(), acc[0].astype(np.int64))


def test_dm_eval_acc_matches_jax_and_oracle(ctx, port):
    cc = ctx[0]
    p = cc.params.lwe
    acc, a = step_inputs(cc, 2)
    be = TorchBackend("cpu")
    assert be._path(port[0]) == "dm"
    got = be.eval_acc(*port, acc.copy(), a, p.q)
    assert got.dtype == np.uint64
    assert np.array_equal(got, RefBackend().eval_acc(cc.params, cc.bt_key, acc.copy(), a, p.q))
    jax_be = JaxBackend()
    jax_be.setup(cc.params, cc.bt_key)
    assert np.array_equal(got, np.asarray(jax_be.eval_acc(cc.params, cc.bt_key, acc.copy(),
                                                          a, p.q), dtype=np.uint64))


@pytest.mark.parametrize("gate", list(Gate), ids=lambda g: g.name)
def test_dm_gate_matches_jax_and_oracle(ctx, port, gate):
    """Gates reach bootstrap_pipeline through the scheme's generic path (no
    fused gate path, no device chain on DM), as in the JAX package."""
    cc, sk = ctx
    m1, m2 = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    ct1, ct2 = cc.encrypt(sk, m1), cc.encrypt(sk, m2)
    tc = tfhe_tpu_torch.BinFHEContext(seed=1, device="cpu")
    tc.params = port[0]
    tc.bt_key_load(port[1])
    got = tc.eval_bin_gate(tfhe_tpu_torch.Gate(int(gate)), convert.ciphertext_from(ct1),
                           convert.ciphertext_from(ct2))
    assert not tc.backend.chain_supported(*port)
    assert np.array_equal(cc.decrypt(sk, got), TRUTH[gate](m1, m2))
    for backend in (RefBackend(), JaxBackend()):
        cc.use_backend(backend)
        want = cc.eval_bin_gate(gate, ct1, ct2)
        assert np.array_equal(np.asarray(want.a), got.a)
        assert np.array_equal(np.asarray(want.b), got.b) and want.modulus == got.modulus
    cc.device_clean()
