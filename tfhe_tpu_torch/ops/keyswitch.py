"""Fused modswitch -> keyswitch -> modswitch in torch (single-limb qKS).

Port of `tfhe_tpu/ops/keyswitch32.py:build_mkm_switch`, the analogue of the
reference's `MKMSwitchKernel` (bootstrapping.cu:73-118): round the extracted
mod-Q ciphertext to qKS, subtract the switching-key rows its base-baseKS
digits select, round to fmod.

The JAX package expresses the row selection as a one-hot int8 matmul for the
TPU's matrix unit. At STD128 that is [B, 262144] x [262144, 1026] per batch,
8.8e15 integer operations at batch 16384, seconds even at the H100's int8
peak. Here, as in the reference, the selected rows of the flat table
`[N * baseKS * dc, n + 1]` are gathered and summed (about 4 MB of rows per
ciphertext at STD128), chunked over the batch to bound the transient.
"""

from __future__ import annotations

import numpy as np
import torch

from .modmath import mod, negmod, round_q_Q, submod

_CHUNK_BYTES = 1 << 28  # gathered rows held at once


def ksk_table(ksk_a: np.ndarray, ksk_b: np.ndarray) -> torch.Tensor:
    """Switching key A [N, baseKS, dc, n], B [N, baseKS, dc] (residues mod
    qKS < 2^31) -> int32 [N*baseKS*dc, n + 1], row (i*baseKS + v)*dc + j,
    columns A then B."""
    a = np.asarray(ksk_a)
    n = a.shape[-1]
    out = np.empty((a.size // n, n + 1), dtype=np.int32)
    out[:, :n] = a.reshape(-1, n)
    out[:, n] = np.asarray(ksk_b).reshape(-1)
    return torch.from_numpy(out)


def mkm_switch(a_ext: torch.Tensor, b_ext: torch.Tensor, table: torch.Tensor,
               Q: int, q_ks: int, base_ks: int, digit_count: int, fmod: int):
    """(a_ext [B, N], b_ext [B]) int64 residues mod Q -> (a [B, n], b [B])
    int64 residues mod fmod, through the key `table` from `ksk_table`."""
    B, N = a_ext.shape
    n = table.shape[1] - 1
    a1 = round_q_Q(a_ext, q_ks, Q)
    b1 = round_q_Q(b_ext, q_ks, Q)

    digits = []
    for _ in range(digit_count):
        digits.append(a1 % base_ks)
        a1 = a1 // base_ks
    dev = a_ext.device
    rows = ((torch.arange(N, device=dev)[:, None] * base_ks
             + torch.stack(digits, dim=-1)) * digit_count
            + torch.arange(digit_count, device=dev))            # [B, N, dc]
    rows = rows.reshape(B, N * digit_count)

    # Exact sums of N*dc terms < qKS. Summing in int64 first casts the
    # gathered int32 rows to a second, twice larger copy, so int32 is used
    # wherever it cannot overflow (STD128: 2048 terms < 2^14).
    sum_dtype = torch.int32 if N * digit_count * (q_ks - 1) < (1 << 31) \
        else torch.int64
    chunk = max(1, _CHUNK_BYTES // (N * digit_count * (n + 1) * 4))
    sums = mod(torch.cat([table[rows[i:i + chunk]].sum(dim=1, dtype=sum_dtype)
                          for i in range(0, B, chunk)]).to(torch.int64), q_ks)

    a2 = negmod(sums[:, :n], q_ks)
    b2 = submod(b1, sums[:, n], q_ks)
    return round_q_Q(a2, fmod, q_ks), round_q_Q(b2, fmod, q_ks)
