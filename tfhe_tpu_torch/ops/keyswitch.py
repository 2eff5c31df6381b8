"""Fused modswitch -> keyswitch -> modswitch in torch.

Port of `tfhe_tpu/ops/keyswitch32.py:build_mkm_switch` (qKS < 2^31) and
`tfhe_tpu/ops/keyswitch64.py:build_mkm_switch64` (power-of-two qKS in
(2^32, 2^40) with a power-of-two baseKS, the accelerated sets' qKS = 2^35),
the analogue of the reference's `MKMSwitchKernel` (bootstrapping.cu:73-118):
round the extracted mod-Q ciphertext to qKS, subtract the switching-key rows
its base-baseKS digits select, round to fmod.

The JAX package expresses the row selection as a one-hot int8 matmul for the
TPU's matrix unit. At STD128 that is [B, 262144] x [262144, 1026] per batch,
8.8e15 integer operations at batch 16384, seconds even at the H100's int8
peak. Here, as in the reference, the selected rows of the flat table
`[N * baseKS * dc, n + 1]` are summed: a float64 table summed by
`embedding_bag`, which never writes the selected rows out. Every partial sum
is an integer below 2^53 (2048 rows below 2^14 at STD128, 14336 rows below
2^35 at the accelerated sets; `row_sums` splits the rows where they would
not be), so the float64 sums are exact in any order.
On an NVIDIA H100 80GB HBM3 (700 W) at batch 4096 this took 14.3 ms at
STD128 and 265.6 ms at the accelerated sets, against 28.8 and 736.0 ms for
gathering the selected rows from an integer table and summing them
(scripts/torch_profile_rns.py --ks-only [--gate]).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .modmath import mod, negmod, round_q_Q, submod

_TABLE_ROWS = 1 << 14    # rows carried to the device per copy


def ksk_table(ksk_a: np.ndarray, ksk_b: np.ndarray,
              device: str | torch.device = "cpu") -> torch.Tensor:
    """Switching key A [N, baseKS, dc, n], B [N, baseKS, dc] (residues mod
    qKS) -> [N*baseKS*dc, n + 1] on `device`, row (i*baseKS + v)*dc + j,
    columns A then B, float64 (see `row_sums`). The table is filled in row
    blocks straight into the device tensor, so the host holds no second
    copy of the key."""
    a = np.asarray(ksk_a)
    n = a.shape[-1]
    a = a.reshape(-1, n)
    b = np.asarray(ksk_b).reshape(-1)
    out = torch.empty((a.shape[0], n + 1), dtype=torch.float64, device=device)
    for i in range(0, a.shape[0], _TABLE_ROWS):
        blk = np.empty((min(_TABLE_ROWS, a.shape[0] - i), n + 1), dtype=np.float64)
        blk[:, :n] = a[i:i + _TABLE_ROWS]
        blk[:, n] = b[i:i + _TABLE_ROWS]
        out[i:i + blk.shape[0]] = torch.from_numpy(blk)
    return out


def seeded_ksk_table(ksk, device: str | torch.device = "cpu") -> torch.Tensor:
    """The `ksk_table` of a `lwe.SeededSwitchingKey`, its A columns
    regenerated on `device` block by block from the key's threefry stream
    (`lwe.seeded_rows`): equal to `ksk_table(ksk.A, ksk.B, device)`, and the
    A block never exists on the host."""
    from .. import lwe

    n, R = ksk.n, ksk.rows
    out = torch.empty((R, n + 1), dtype=torch.float64, device=device)
    for r0, r1 in lwe.seeded_blocks(R, n, device):
        out[r0:r1, :n] = lwe.seeded_rows(ksk.seed, n, ksk.q_ks, r0, r1, device)
    out[:, n] = torch.from_numpy(
        np.asarray(ksk.B, dtype=np.uint64).reshape(-1).astype(np.float64)).to(device)
    return out


def key_rows(a1: torch.Tensor, N: int, base_ks: int,
             digit_count: int) -> torch.Tensor:
    """a1 [B, N] residues mod qKS -> [B, N*dc] table rows
    (i*baseKS + digit_j(a1[i]))*dc + j that its base-baseKS digits select."""
    B = a1.shape[0]
    digits = []
    for _ in range(digit_count):
        digits.append(mod(a1, base_ks))
        a1 = a1 // base_ks
    dev = a1.device
    rows = ((torch.arange(N, device=dev)[:, None] * base_ks
             + torch.stack(digits, dim=-1)) * digit_count
            + torch.arange(digit_count, device=dev))            # [B, N, dc]
    return rows.reshape(B, N * digit_count)


def row_sums(table: torch.Tensor, rows: torch.Tensor, q_ks: int) -> torch.Tensor:
    """The sums of the selected rows of the float64 table, [B, n + 1] int64
    mod qKS. The rows are summed in chunks small enough that every float64
    partial sum stays an exact integer below 2^53 (one chunk at every set
    of the tables; several where N * dc * (qKS - 1) reaches 2^53, as at
    N = 2048, qKS = 2^39, baseKS = 16); the chunks' sums are added in
    int64."""
    chunk = ((1 << 53) - 1) // (q_ks - 1)
    total = None
    for i in range(0, rows.shape[1], chunk):
        part = mod(F.embedding_bag(rows[:, i:i + chunk].contiguous(), table,
                                   mode="sum").to(torch.int64), q_ks)
        total = part if total is None else mod(total + part, q_ks)
    return total


def mkm_switch(a_ext: torch.Tensor, b_ext: torch.Tensor, table: torch.Tensor,
               Q: int, q_ks: int, base_ks: int, digit_count: int, fmod: int):
    """(a_ext [B, N], b_ext [B]) int64 residues mod Q -> (a [B, n], b [B])
    int64 residues mod fmod, through the key `table` from `ksk_table`."""
    N = a_ext.shape[1]
    n = table.shape[1] - 1
    if q_ks > (1 << 31) and (q_ks & (q_ks - 1) or base_ks & (base_ks - 1)):
        raise ValueError("a qKS above 2^31 needs power-of-two qKS and baseKS")
    rows = key_rows(round_q_Q(a_ext, q_ks, Q), N, base_ks, digit_count)
    sums = row_sums(table, rows, q_ks)
    a2 = negmod(sums[:, :n], q_ks)
    b2 = submod(round_q_Q(b_ext, q_ks, Q), sums[:, n], q_ks)
    return round_q_Q(a2, fmod, q_ks), round_q_Q(b2, fmod, q_ks)
