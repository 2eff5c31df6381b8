"""tfhe_tpu_torch.ops.keyswitch.mkm_switch against
tfhe_tpu.ops.keyswitch32.build_mkm_switch, exactly, on one random key per
case: a power-of-two baseKS (STD128's 2^7 with qKS = 2^14) and TOY's
baseKS = 25 with qKS = Q."""

import numpy as np
import pytest
import torch

from tfhe_tpu.ops import keyswitch32 as ks32
from tfhe_tpu.params import ParamSet, _digit_count, from_param_set
from tfhe_tpu_torch.ops import keyswitch

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
    """Batch chunks of one ciphertext give the same sums as one chunk."""
    N, n, B, q_ks, base_ks, dc = 32, 4, 5, 1 << 14, 1 << 7, 2
    rng = np.random.default_rng(9)
    table = keyswitch.ksk_table(
        rng.integers(0, q_ks, (N, base_ks, dc, n)),
        rng.integers(0, q_ks, (N, base_ks, dc)))
    a = torch.from_numpy(rng.integers(0, Q_STD128, (B, N)))
    b = torch.from_numpy(rng.integers(0, Q_STD128, B))
    whole = keyswitch.mkm_switch(a, b, table, Q_STD128, q_ks, base_ks, dc, 1024)
    monkeypatch.setattr(keyswitch, "_CHUNK_BYTES", 1)
    split = keyswitch.mkm_switch(a, b, table, Q_STD128, q_ks, base_ks, dc, 1024)
    assert all(torch.equal(x, y) for x, y in zip(whole, split))


def test_ksk_table_layout():
    rng = np.random.default_rng(10)
    A = rng.integers(0, 1 << 14, (4, 3, 2, 5)).astype(np.uint16)
    Bk = rng.integers(0, 1 << 14, (4, 3, 2)).astype(np.uint64)
    t = keyswitch.ksk_table(A, Bk)
    assert t.dtype == torch.int32 and tuple(t.shape) == (24, 6)
    i, v, j = 2, 1, 1
    row = (i * 3 + v) * 2 + j
    assert np.array_equal(t[row, :5].numpy(), A[i, v, j].astype(np.int32))
    assert int(t[row, 5]) == int(Bk[i, v, j])
