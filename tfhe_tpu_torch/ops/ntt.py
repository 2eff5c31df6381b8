"""Plain negacyclic NTT in torch, in the permutation-free order.

Port of `tfhe_tpu/ops/ntt32.py` and of the schedule in `ntt_sched.py` (a
copy of `tfhe_tpu/ops/ntt_sched.py`): forward = twist by psi^j, then
Gentleman-Sande stages with half-length N/2 .. 1, taking natural order to
**bit-reversed evaluation order**; inverse = Cooley-Tukey stages with
half-length 1 .. N/2, then untwist by psi^-j / N. The evaluation order is
the one the packed bootstrapping keys are stored in
(`rotate_kernel.pack_bsk`, `rotate_rns_kernel.pack_bsk_rns`,
`rotate64_kernel.pack_bsk64`); the hand kernels run a negacyclic NTT with
merged twiddles (`merged_tables`) that gives the same order.

Values are int64 residues mod Q on the last axis. Below 2^31 a product of
two residues is exact in int64 and reduced with `%`; for Q up to 2^54 (the
two-limb sets, the counterpart of `tfhe_tpu/ops/ntt64.py`) every product is
the exact 64-bit Shoup product of `modmath.mulmod_shoup64`, with the
twiddles' companions from `modmath.shoup64`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modmath as mm
from .ntt_sched import schedule


@functools.lru_cache(maxsize=None)
def tables(N: int, Q: int) -> np.ndarray:
    """uint64 [4, N]: twist, forward twiddles, inverse twiddles, untwist
    (N^-1 folded in). The stage with half-length h reads entries [h, 2h) of
    its twiddle row: entry h + t multiplies the t-th butterfly of every
    block, as the schedule's odd-half lane h + t of that stage does."""
    sch = schedule(N, Q)
    logn = N.bit_length() - 1
    fwd = np.zeros(N, dtype=np.uint64)
    inv = np.zeros(N, dtype=np.uint64)
    for k in range(logn):
        h = N >> (k + 1)
        fwd[h:2 * h] = sch["fwd_w"][k][h:2 * h]
        h = 1 << k
        inv[h:2 * h] = sch["inv_w"][k][h:2 * h]
    return np.stack([sch["twist"], fwd, inv, sch["untwist"]])


def merged_tables(N: int, q: int) -> np.ndarray:
    """int64 [2, N]: the merged-twiddle NTT's tables mod q (see
    csrc/register_ntt.cuh), for the hand kernels `rotate_kernel`,
    `rotate_rns_kernel` and `rotate64_kernel` launch (exact up to q < 2^54:
    Python ints). Forward: entry m >= 1 is psi^brv(m), the Cooley-Tukey
    twiddle of block m - m0 at the stage with m0 blocks; entry 0 is 1 (its
    Shoup companion, floor(2^32 / q) or floor(2^64 / q), reduces the lazy
    sums). Inverse: entry m >= 2 is psi^-brv(m), the Gentleman-Sande
    twiddle; entry 1 is psi^-brv(1) N^-1 and entry 0 N^-1, the last
    stage's two factors. psi is the root of `forward`'s twist, so the
    merged forward's output order is `forward`'s."""
    sch = schedule(N, q)
    psi, brv = int(sch["twist"][1]), sch["bitrev"]
    psi_inv, n_inv = pow(psi, -1, q), pow(N, -1, q)
    fwd = [pow(psi, int(e), q) for e in brv]
    inv = [pow(psi_inv, int(e), q) for e in brv]
    fwd[0], inv[0], inv[1] = 1, n_inv, inv[1] * n_inv % q
    return np.array([fwd, inv], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def tables_on(N: int, Q: int, device: str) -> torch.Tensor:
    """int64 [8, N] on `device`: the four rows of `tables`, then their
    64-bit Shoup companions (`modmath.shoup64`, the int64 view of u64)."""
    tab = tables(N, Q)
    both = np.concatenate([tab.astype(np.int64), mm.shoup64(tab, Q)])
    return torch.from_numpy(both).to(device)


def _mul(x: torch.Tensor, t: torch.Tensor, row: int, cols: slice, Q: int) -> torch.Tensor:
    """x * tables[row, cols] mod Q, exactly (t from `tables_on`)."""
    if Q < (1 << 31):
        return x * t[row, cols] % Q
    return mm.mulmod_shoup64(x, t[row, cols], t[4 + row, cols], Q)


def forward(x: torch.Tensor, Q: int) -> torch.Tensor:
    """Coefficients [..., N] -> evaluation values in bit-reversed order."""
    shape, N = x.shape, x.shape[-1]
    t = tables_on(N, Q, str(x.device))
    x = _mul(x, t, 0, slice(None), Q)
    h = N // 2
    while h >= 1:
        y = x.reshape(*shape[:-1], N // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack([(a + b) % Q,
                         _mul((a - b) % Q, t, 1, slice(h, 2 * h), Q)],
                        dim=-2).reshape(shape)
        h //= 2
    return x


def inverse(x: torch.Tensor, Q: int) -> torch.Tensor:
    """Evaluation values in bit-reversed order [..., N] -> coefficients."""
    shape, N = x.shape, x.shape[-1]
    t = tables_on(N, Q, str(x.device))
    h = 1
    while h < N:
        y = x.reshape(*shape[:-1], N // (2 * h), 2, h)
        a = y[..., 0, :]
        c = _mul(y[..., 1, :], t, 2, slice(h, 2 * h), Q)
        x = torch.stack([(a + c) % Q, (a - c) % Q], dim=-2).reshape(shape)
        h *= 2
    return _mul(x, t, 3, slice(None), Q)
