"""Plain batched CGGI blind rotation mod one big ring modulus Q < 2^54.

Port of `tfhe_tpu/ops/blindrotate64.py` (`_decompose64`,
`build_blind_rotate64`, `transpose_extract64`), which carries the
accumulator as (lo, hi) uint32 pairs. Here every residue is an int64: the
digits are `blindrotate.decompose`'s (centred with acc >= Q/2 negative, as
`pallas_rotate64.py:256-258` does), the NTTs take `ntt`'s exact 64-bit
Shoup products, and the external product multiplies by the key's values and
companions (`blindrotate.external_round`). The monomials (`rotate_sub`) and
the extract (`transpose_extract`) do not depend on the size of Q.

It reads the key in `rotate64_kernel.pack_bsk64`'s layout, which holds the
64-bit Shoup companions only; the values are rebuilt from them, so this is
the plain version of the hand-written kernel: the CPU path of
`rotate64_kernel.rotate64`, and the oracle the kernel is held to on the
card.
"""

from __future__ import annotations

import torch

from .blindrotate import decompose, external_round
from .modmath import shoup64_values


def blind_rotate64(acc: torch.Tensor, a_idx: torch.Tensor,
                   bsk64: torch.Tensor, Q: int, base_g: int,
                   throw: int = 0) -> torch.Tensor:
    """acc [B, 2, N] int64 residues mod Q, a_idx [B, n] int32 exponents in
    [0, 2N), bsk64 [n, 4*d2, N] int64 companions from `pack_bsk64` -> acc
    [B, 2, N] int64 after n rounds."""
    n, rows, N = bsk64.shape
    d2 = rows // 4
    sh = bsk64.reshape(n, 2, 2, d2, N)
    vals = shoup64_values(sh, Q)
    a_idx = a_idx.to(torch.int64)
    for r in range(n):
        acc = external_round(acc, decompose(acc, Q, base_g, d2 // 2, throw),
                             vals[r], a_idx[:, r], Q, sh[r])
    return acc
