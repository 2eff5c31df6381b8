"""tfhe_tpu_torch.ops.keyswitch.mkm_switch against
tfhe_tpu.ops.keyswitch32.build_mkm_switch and, at the accelerated sets'
qKS = 2^35, tfhe_tpu.ops.keyswitch64.build_mkm_switch64, exactly, on one
random key per case: a power-of-two baseKS (STD128's 2^7 with qKS = 2^14),
TOY's baseKS = 25 with qKS = Q, and baseKS = 32 with qKS = 2^35 from the
composite Q = q1*q2; and at qKS = 2^39, N = 2048, where the row sums are
taken in chunks, against the JAX package's host switch
(tfhe_tpu.lwe.mod_switch and key_switch)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tfhe_tpu import lwe as jax_lwe
from tfhe_tpu.ops import keyswitch32 as ks32
from tfhe_tpu.ops import keyswitch64 as ks64
from tfhe_tpu.ops import modmath64 as mm64
from tfhe_tpu.params import ParamSet, _digit_count, from_gpu_style, from_param_set
from tfhe_tpu_torch.ops import keyswitch
from torch_threads import one_torch_thread  # noqa: F401

Q_TOY = from_param_set(ParamSet.TOY).lwe.Q
Q_STD128 = from_param_set(ParamSet.STD128).lwe.Q


@pytest.mark.parametrize("Q,q_ks,base_ks,fmod", [
    (Q_STD128, 1 << 14, 1 << 7, 1024),
    (Q_TOY, Q_TOY, 25, 512),
])
def test_mkm_switch_matches_jax(Q, q_ks, base_ks, fmod):
    N, n, B = 64, 8, 16
    dc = _digit_count(q_ks, base_ks)
    rng = np.random.default_rng(8)
    ksk_a = rng.integers(0, q_ks, (N, base_ks, dc, n)).astype(np.uint64)
    ksk_b = rng.integers(0, q_ks, (N, base_ks, dc)).astype(np.uint64)
    a_ext = rng.integers(0, Q, (B, N)).astype(np.uint32)
    b_ext = rng.integers(0, Q, B).astype(np.uint32)
    a_ext[0, :3] = [0, Q - 1, Q // 2]

    fn = ks32.build_mkm_switch(N, Q, q_ks, base_ks, dc, n, fmod)
    want_a, want_b = fn(a_ext, b_ext, ks32.pack_ksk(ksk_a.reshape(-1, n),
                                                   ksk_b.reshape(-1), q_ks))
    got_a, got_b = keyswitch.mkm_switch(
        torch.from_numpy(a_ext.astype(np.int64)),
        torch.from_numpy(b_ext.astype(np.int64)),
        keyswitch.ksk_table(ksk_a, ksk_b), Q, q_ks, base_ks, dc, fmod)
    assert np.array_equal(got_a.numpy(), np.asarray(want_a).astype(np.int64))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b).astype(np.int64))


def test_mkm_switch_chunking_is_exact(monkeypatch):
    """A table carried to the device in row blocks of one row gives the same
    table and the same switch as one block."""
    N, n, B, q_ks, base_ks, dc = 32, 4, 5, 1 << 14, 1 << 7, 2
    rng = np.random.default_rng(9)
    ksk = (rng.integers(0, q_ks, (N, base_ks, dc, n)),
           rng.integers(0, q_ks, (N, base_ks, dc)))
    a = torch.from_numpy(rng.integers(0, Q_STD128, (B, N)))
    b = torch.from_numpy(rng.integers(0, Q_STD128, B))
    table = keyswitch.ksk_table(*ksk)
    whole = keyswitch.mkm_switch(a, b, table, Q_STD128, q_ks, base_ks, dc, 1024)
    monkeypatch.setattr(keyswitch, "_TABLE_ROWS", 1)
    blocks = keyswitch.ksk_table(*ksk)
    split = keyswitch.mkm_switch(a, b, blocks, Q_STD128, q_ks, base_ks, dc, 1024)
    assert torch.equal(table, blocks)
    assert all(torch.equal(x, y) for x, y in zip(whole, split))


def test_ksk_table_layout():
    rng = np.random.default_rng(10)
    A = rng.integers(0, 1 << 14, (4, 3, 2, 5)).astype(np.uint16)
    Bk = rng.integers(0, 1 << 14, (4, 3, 2)).astype(np.uint64)
    t = keyswitch.ksk_table(A, Bk)
    assert t.dtype == torch.float64 and tuple(t.shape) == (24, 6)
    i, v, j = 2, 1, 1
    row = (i * 3 + v) * 2 + j
    assert np.array_equal(t[row, :5].numpy(), A[i, v, j].astype(np.float64))
    assert int(t[row, 5]) == int(Bk[i, v, j])


Q_RNS = from_gpu_style(ParamSet.STD128, True, 12).lwe.Q


@pytest.mark.parametrize("fmod", [1024, 2048, 4096])
def test_mkm_switch_35bit_matches_jax(fmod, monkeypatch):
    """qKS = 2^35, baseKS = 32 (7 digits) from Q ~ 2^54, the table carried
    in several row blocks: float64 rows summed by embedding_bag."""
    N, n, B, q_ks, base_ks = 64, 8, 12, 1 << 35, 32
    dc = _digit_count(q_ks, base_ks)
    rng = np.random.default_rng(11)
    ksk_a = rng.integers(0, q_ks, (N, base_ks, dc, n)).astype(np.uint64)
    ksk_b = rng.integers(0, q_ks, (N, base_ks, dc)).astype(np.uint64)
    a_ext = rng.integers(0, Q_RNS, (B, N)).astype(np.uint64)
    b_ext = rng.integers(0, Q_RNS, B).astype(np.uint64)
    a_ext[0, :3] = [0, Q_RNS - 1, Q_RNS // 2]

    fn = ks64.build_mkm_switch64(N, Q_RNS, q_ks, base_ks, dc, n, fmod)
    want_a, want_b = fn(*mm64.pack_host(a_ext), *mm64.pack_host(b_ext),
                        ks64.pack_ksk64(ksk_a.reshape(-1, n), ksk_b.reshape(-1), q_ks))
    monkeypatch.setattr(keyswitch, "_TABLE_ROWS", 1000)
    table = keyswitch.ksk_table(ksk_a, ksk_b)
    assert table.dtype == torch.float64
    got_a, got_b = keyswitch.mkm_switch(
        torch.from_numpy(a_ext.astype(np.int64)),
        torch.from_numpy(b_ext.astype(np.int64)),
        table, Q_RNS, q_ks, base_ks, dc, fmod)
    assert np.array_equal(got_a.numpy(), np.asarray(want_a).astype(np.int64))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b).astype(np.int64))



def test_mkm_switch_row_sums_in_exact_chunks():
    """N = 2048, qKS = 2^39, baseKS = 16 (dc = 10): 20480 selected rows of
    values below 2^39, so one float64 sum over all of them could pass 2^53;
    `row_sums` sums them in chunks. The JAX package's device switch
    (`build_mkm_switch64`) stops at qKS = 2^35 (its 7-bit limbs are shifted
    within 32 bits), so the port is held to its host switch, the oracle
    `RefBackend.mkm_switch` runs: mod_switch, key_switch, mod_switch."""
    N, n, B, q_ks, base_ks, fmod = 2048, 4, 3, 1 << 39, 16, 2048
    dc = _digit_count(q_ks, base_ks)
    assert dc == 10 and N * dc * (q_ks - 1) >= 1 << 53
    rng = np.random.default_rng(12)
    ksk_a = rng.integers(0, q_ks, (N, base_ks, dc, n)).astype(np.uint64)
    ksk_b = rng.integers(0, q_ks, (N, base_ks, dc)).astype(np.uint64)
    a_ext = rng.integers(0, Q_RNS, (B, N)).astype(np.uint64)
    b_ext = rng.integers(0, Q_RNS, B).astype(np.uint64)
    a_ext[0, :3] = [0, Q_RNS - 1, Q_RNS // 2]

    p = SimpleNamespace(n=n, N=N, q_ks=q_ks, base_ks=base_ks, digit_count_ks=dc)
    ct = jax_lwe.mod_switch(q_ks, jax_lwe.LWECiphertext(a_ext, b_ext, Q_RNS))
    ct = jax_lwe.key_switch(p, jax_lwe.LWESwitchingKey(A=ksk_a, B=ksk_b), ct)
    want = jax_lwe.mod_switch(fmod, ct)
    got_a, got_b = keyswitch.mkm_switch(
        torch.from_numpy(a_ext.astype(np.int64)),
        torch.from_numpy(b_ext.astype(np.int64)),
        keyswitch.ksk_table(ksk_a, ksk_b), Q_RNS, q_ks, base_ks, dc, fmod)
    assert torch.equal(got_a, torch.from_numpy(np.asarray(want.a).astype(np.int64)))
    assert torch.equal(got_b, torch.from_numpy(np.asarray(want.b).astype(np.int64)))
