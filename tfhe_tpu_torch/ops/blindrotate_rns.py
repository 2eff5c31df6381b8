"""Plain batched CGGI blind rotation on a two-prime RNS ring modulus.

What `tfhe_tpu/ops/pallas_rotate_rns.py:build_pallas_rotate_rns` computes,
in torch (its XLA twin is `tfhe_tpu/ops/blindrotate64.py` at the same
composite Q = q1*q2): the accumulator is kept as two residue lanes mod q1
and mod q2. Each round, Garner CRT gives the positional value mod Q, which
is centred (x >= Q/2 is negative) and split into balanced base-G digits,
the lowest `throw` dropped; the signed digits are mapped into both lanes,
and the rest of the round (NTT, external product, inverse NTT,
(X^a - 1)/(X^-a - 1), accumulation) runs per lane with
`blindrotate.external_round`.

It reads the key in `rotate_rns_kernel.pack_bsk_rns`'s layout, which holds
per-lane Shoup companions only; the values are rebuilt from them, so this is
the plain version of the hand-written kernel: the CPU path of
`rotate_rns_kernel.rotate_rns`, and the oracle the kernel is held to on the
card. All values are exact int64 residues.
"""

from __future__ import annotations

import torch

from .blindrotate import external_round, signed_digits
from .modmath import crt_combine


def key_values(bsk_rns: torch.Tensor, q1: int, q2: int) -> list[torch.Tensor]:
    """Packed key [n, 8*d2, N] int32 (Shoup companions b' of both lanes) ->
    per lane the values [n, 2(key), 2(out), d2, N] int64, rebuilt as
    b = hi32(b' * qi) + (lo32(b' * qi) != 0)."""
    n, rows, N = bsk_rns.shape
    d2 = rows // 8
    sh = bsk_rns.to(torch.int64) & 0xFFFFFFFF
    out = []
    for lane, qi in enumerate((q1, q2)):
        p = sh[:, lane * 4 * d2:(lane + 1) * 4 * d2] * qi
        v = (p >> 32) + ((p & 0xFFFFFFFF) != 0).to(torch.int64)
        out.append(v.reshape(n, 2, 2, d2, N))
    return out


def blind_rotate_rns(acc1: torch.Tensor, acc2: torch.Tensor,
                     a_idx: torch.Tensor, bsk_rns: torch.Tensor, q1: int,
                     q2: int, base_g: int, throw: int = 0):
    """acc1, acc2 [B, 2, N] int32 residues mod q1 and q2, a_idx [B, n]
    int32 exponents in [0, 2N), bsk_rns [n, 8*d2, N] int32 from
    `pack_bsk_rns` -> (acc1, acc2) [B, 2, N] int32 after n rounds."""
    n, rows, _ = bsk_rns.shape
    digits = rows // 16
    keys = key_values(bsk_rns, q1, q2)
    Q = q1 * q2
    accs = [acc1.to(torch.int64), acc2.to(torch.int64)]
    a_idx = a_idx.to(torch.int64)
    for r in range(n):
        x = crt_combine(accs[0], accs[1], q1, q2)
        digs = signed_digits(torch.where(x >= (Q >> 1), x - Q, x), base_g,
                             digits, throw)
        accs = [external_round(acc, digs % qi, key[r], a_idx[:, r], qi)
                for acc, key, qi in zip(accs, keys, (q1, q2))]
    return accs[0].to(torch.int32), accs[1].to(torch.int32)
