"""Batched DM/AP blind rotation in torch (Q < 2^31).

Port of `tfhe_tpu/ops/blindrotate_dm.py`, the device analogue of
`RingGSWAccumulatorDM::EvalAcc` + `AddToAccDM` (rgsw-acc-dm.cpp:80-149,
306-359), a path the reference never shipped on its GPU (its DM GPU code is
commented out, rgsw-acc-dm.cpp:361-464).

Per step (i, k): the base-R digit a0 of (q - a_i) selects the RGSW key
ek[i][a0][k], and acc <- <decompose(acc), ek>, the sum skipping gadget row 0
as the reference does; a zero digit keeps the accumulator (the reference
skips it). The JAX package selects the key with a one-hot bf16 matrix
product against a 7-bit-limb table, a device for the TPU's matrix unit;
here the table holds int32 residues and the selection is a gather, as the
key switch's is. The JAX function is XLA code outside any Pallas kernel, so
these are torch ops on the port's plain NTT (`ntt.forward`/`inverse`) and
`blindrotate.decompose`, on whatever device the tensors lie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ref import ntt as ref_ntt
from . import ntt
from .blindrotate import decompose
from .modmath import mod, negmod
from .ntt_sched import schedule

_LIMB_BITS = 7


def dm_limbs(Q: int) -> int:
    """7-bit limbs of values < Q in the JAX package's DM table (5 for the
    29-bit STD256 primes, 4 below 2^28): only its size guard reads it."""
    return (int(Q - 1).bit_length() + _LIMB_BITS - 1) // _LIMB_BITS


def pack_dm_table(bsk_coeff: np.ndarray, Q: int,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """DM key in the coefficient domain [n, baseR, digitsR, d2, 2, N] ->
    int32 [n*digitsR, baseR, d2, 2, N] residues in the evaluation domain on
    `device`: step-major (step i*digitsR + k), the selection axis second,
    points in `ntt.forward`'s bit-reversed order. One LWE index at a time
    goes through the host NTT and to the device, so the host holds one
    index's slice of the evaluation-domain key at most."""
    n, base_r, d_r, d2, _, N = np.shape(bsk_coeff)
    bitrev = schedule(N, Q)["bitrev"]
    out = torch.empty((n * d_r, base_r, d2, 2, N), dtype=torch.int32, device=device)
    for i in range(n):
        hat = ref_ntt.forward(np.asarray(bsk_coeff[i], dtype=np.uint64), Q)[..., bitrev]
        out[i * d_r:(i + 1) * d_r] = torch.from_numpy(
            np.swapaxes(hat, 0, 1).astype(np.int32))
    return out


def dm_digits(a: torch.Tensor, a_modulus: int, base_r: int,
              digits_r: int) -> torch.Tensor:
    """LWE a-vectors [B, n] int64 (any representatives mod a_modulus) ->
    the base-R digits of (q - a_i) mod q, [B, n*digitsR] int64 in step
    order (i, k) (rgsw-acc-dm.cpp:120-135)."""
    ai = negmod(mod(a, a_modulus), a_modulus)
    out = []
    for _ in range(digits_r):
        out.append(ai % base_r)
        ai = ai // base_r
    return torch.stack(out, dim=-1).reshape(a.shape[0], -1)


def dm_rotate(acc: torch.Tensor, digits: torch.Tensor, table: torch.Tensor,
              Q: int, base_g: int, digits_g: int) -> torch.Tensor:
    """acc [B, 2, N] int64 residues mod Q, digits [B, n_steps] from
    `dm_digits`, table from `pack_dm_table` -> acc [B, 2, N] after every
    step. Each product of two residues < 2^31 is reduced before the sum
    over the gadget rows, so every value stays exact in int64."""
    for step in range(digits.shape[1]):
        a0 = digits[:, step]
        ek = table[step][a0].to(torch.int64)                  # [B, d2, 2, N]
        dct = ntt.forward(decompose(acc, Q, base_g, digits_g, 0), Q)   # [B, d2, N]
        # gadget rows from 1 (rgsw-acc-dm.cpp:350-358)
        u = (dct[:, 1:, None, :] * ek[:, 1:] % Q).sum(dim=1) % Q      # [B, 2, N]
        acc = torch.where((a0 == 0)[:, None, None], acc, ntt.inverse(u, Q))
    return acc
